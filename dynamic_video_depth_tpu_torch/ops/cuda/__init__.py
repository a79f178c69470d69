"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and launch counters. Importing this package builds nothing: a kernel is
compiled at its first launch on a CUDA tensor (``build.py``)."""

from concurrent.futures import ThreadPoolExecutor

from . import (chain_kernel, corr_kernel, head_conv_kernel, loss_kernel,
               mlp_kernel, warp_kernel)

KERNEL_MODULES = (warp_kernel, mlp_kernel, chain_kernel, loss_kernel,
                  corr_kernel, head_conv_kernel)


def build_all() -> None:
    """Build (or find built) every kernel library now, one nvcc each, all
    at once: a process that starts workers calls it first, so that they
    load the libraries instead of each compiling them."""
    with ThreadPoolExecutor(len(KERNEL_MODULES)) as pool:
        for future in [pool.submit(m._lib) for m in KERNEL_MODULES]:
            future.result()


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
    lookup's (radius, levels), the head convolution's memory order and
    copy width."""
    return dict(warp_kernel.launch_variants() + chain_kernel.variants
                + corr_kernel.variants + head_conv_kernel.variants)
