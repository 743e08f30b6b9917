"""Share of a verification's wall time in which the device ran nothing:
1 - (device busy seconds of the profiled verification) / (median wall
seconds of the window's untraced verifications)."""


def read(run):
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["verify"]["busy_s"] /
                    run.median("verify_s"))
