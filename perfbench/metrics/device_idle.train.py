"""device_idle.train (%): one minus the union of the device's operation
intervals over the traced step, as a share of its length."""


def read(rec):
    tb = rec["trace"]
    if rec["kind"] != "train" or not tb.get("window_s"):
        return None
    return 100.0 * (1.0 - tb["busy_s"] / tb["window_s"])
