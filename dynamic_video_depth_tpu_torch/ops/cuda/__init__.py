"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and launch counters. Importing this package builds nothing: a kernel is
compiled at its first launch on a CUDA tensor (``build.py``)."""

from . import chain_kernel, corr_kernel, loss_kernel, mlp_kernel, warp_kernel

KERNEL_MODULES = (warp_kernel, mlp_kernel, chain_kernel, loss_kernel,
                  corr_kernel)


def reset_launches() -> None:
    for module in KERNEL_MODULES:
        module.reset_launches()


def launch_counts() -> dict:
    counts = {}
    for module in KERNEL_MODULES:
        counts.update(module.launches)
    return counts


def launch_variants() -> dict:
    """Launches since the last reset by the shape that picks a kernel's
    branch: the warp's channel count, the chain's (n_steps, n_evals), the
    lookup's (radius, levels)."""
    return dict(warp_kernel.variants + chain_kernel.variants
                + corr_kernel.variants)
