"""The optimisation core: theta-vector helpers, CG, curvature products,
the stateful optimisers and the collectives of a mesh run.  Port of
``repro.core``."""
