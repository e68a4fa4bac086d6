"""The device's idle share of the traced training window, in %: 100 (1 -
busy / window), busy the union of the device's intervals."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
