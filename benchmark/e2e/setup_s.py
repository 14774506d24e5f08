"""Set-up: process start to the first timed request (imports, the kernel
library's load or build, scene and accel, warm-up)."""


def compute(window):
    return window.setup_s
