"""Plain versions of the RL004 fixture tree: deliberately missing
``orphan_kernel_ref``."""


def paired_kernel_ref(x):
    return x
