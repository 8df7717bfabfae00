"""kernels_per_step: device kernels launched per step (host dispatch): the
count of kernel events in the traced stretch over its steps."""


def read(summary: dict):
    if not summary["steps"] or not summary["kernel_count"]:
        return None
    return summary["kernel_count"] / summary["steps"]
