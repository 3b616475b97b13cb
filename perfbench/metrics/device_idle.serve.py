"""device_idle.serve (%): one minus the union of the device's operation
intervals over the traced commits, as a share of its length."""


def read(rec):
    tb = rec["trace"]
    if rec["kind"] != "serve" or not tb.get("window_s"):
        return None
    return 100.0 * (1.0 - tb["busy_s"] / tb["window_s"])
