"""Peak device memory allocated during the window alone, GiB: the
attest-time peak, which the set-up peak hides inside peak_gib."""


def read(run):
    return run.window_peak_bytes / float(1 << 30)
