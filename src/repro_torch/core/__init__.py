"""The optimisation core: theta-vector helpers, CG, curvature products and
the stateful optimisers.  Port of ``repro.core``."""
