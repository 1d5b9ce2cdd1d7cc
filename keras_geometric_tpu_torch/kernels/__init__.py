"""Hopper kernel tier: hand-written CUDA kernels, built at first use.

Each wrapper module counts its kernels' launches (``LAUNCH_COUNTS``; some also
count by mode or route, ``MODE_LAUNCH_COUNTS``) where it launches a kernel on
the card and nowhere else. The functions below read and reset every module's
counts at once; they import the wrapper modules when called, which builds
nothing.
"""


def kernel_modules() -> tuple:
    """Every wrapper module that counts launches."""
    from . import attend_cuda, band_cuda, sddmm_cuda, softmax_cuda, spmm_cuda

    return spmm_cuda, attend_cuda, softmax_cuda, sddmm_cuda, band_cuda


def launch_counts() -> dict:
    """Every kernel's count of launches, from every wrapper module."""
    counts = {}
    for module in kernel_modules():
        counts.update(module.LAUNCH_COUNTS)
    return counts


def mode_launch_counts() -> dict:
    """Launches of the attention kernels in their other modes, of the wide
    segment max's backward with the ties split and of the band kernel by
    route (counted beside their kernel's own count)."""
    counts = {}
    for module in kernel_modules():
        counts.update(getattr(module, "MODE_LAUNCH_COUNTS", {}))
    return counts


def reset_launch_counts() -> None:
    for module in kernel_modules():
        module.reset_launch_counts()
