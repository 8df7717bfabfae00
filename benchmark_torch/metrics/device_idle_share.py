"""device_idle_share: the share of the traced window, in %, in which no
kernel, copy or fill ran on the device; nothing where no device work was
traced at all."""


def read(summary: dict):
    if summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
