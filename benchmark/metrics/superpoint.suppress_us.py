"""``superpoint.suppress_us``: kernel 6's (``csrc/detect_suppress.cu``)
mean device time per launch in the traced run's profiled calls
(torch.profiler, kernels named ``detect_suppress``), in us: SuperPoint's
greedy radius-4 suppression at 1024x768, on the kernel's list path. None
where no launch was traced."""


def read(record):
    p = record.profile
    if p is None:
        return None
    launches, seconds = p.kernel("detect_suppress")
    if launches == 0:
        return None
    return seconds / launches * 1e6
