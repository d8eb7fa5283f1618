"""Seeded RL004 violations: a launching wrapper with no plain version
and no test, and (csrc/unlaunched.cu) a CUDA source nothing launches.
Parsed, never imported."""
from repro_torch.kernels import build, ref


def _launch(fn, device, *args):
    build.launch("used", {}, fn, device, *args)


def orphan_kernel(x):                    # RL004: no orphan_kernel_ref
    _launch("orphan_launch", x.device, x.data_ptr())
    return x


def paired_kernel(x):                    # has paired_kernel_ref
    if not x.is_cuda:
        return ref.paired_kernel_ref(x)
    _launch("paired_launch", x.device, x.data_ptr())
    return x


def _private_helper(x):                  # private: exempt from RL004
    build.launch("used", {}, "helper_launch", x.device)
