"""Device ms a update under PyTorch's own `Optimizer.step#AdamW.step` range."""


def read(view):
    s = view.range_device_s("Optimizer.step#AdamW.step")
    if s is None or view.updates == 0:
        return None
    return 1e3 * s / view.updates
