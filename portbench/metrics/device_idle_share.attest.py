"""Share of an attestation's wall time in which the device ran nothing:
1 - (device busy seconds of the profiled attestation) / (median wall
seconds of the window's untraced attestations)."""


def read(run):
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["attest"]["busy_s"] /
                    run.median("attest_s"))
