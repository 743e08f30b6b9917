"""K1 (Poseidon2) share of its roofline in the profiled attestation: the
least time the card could take for the work of every K1 call made
(portbench/cost.py, from each call's logical shape) over the device time
of K1's kernels in the trace."""


def read(run):
    if run.profile is None:
        return None
    p = run.profile["attest"]
    if not p["group_calls"]["k1"] or not p["group_device_s"]["k1"]:
        return None
    return 100.0 * p["group_bound_s"]["k1"] / p["group_device_s"]["k1"]
