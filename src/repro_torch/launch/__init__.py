"""Step builders, the training driver, meshes of ranks and the sharding
rules.  Port of ``repro.launch``."""
