"""Share (%) of the roofline of the noise_est op entry over every group that
launches it: sum of the bounds counted from the groups' shapes (peaks.py) /
sum of the CUDA-event times of the op at those shapes; flat cells."""


def read(run):
    rows = run.get("kernels", {}).get("noise_est", [])
    if run["loop"] != "flat" or not rows or sum(ms for _, ms in rows) <= 0:
        return None
    return 100.0 * sum(b for b, _ in rows) / sum(ms for _, ms in rows)
