"""K3 (fused sum-check rounds) share of its roofline in the profiled
attestation: the least time the card could take for the work of every K3
call made (portbench/cost.py, from each call's (d, n, claims), padded
claims left out) over the device time of K3's kernels in the trace."""


def read(run):
    if run.profile is None:
        return None
    p = run.profile["attest"]
    if not p["group_calls"]["k3"] or not p["group_device_s"]["k3"]:
        return None
    return 100.0 * p["group_bound_s"]["k3"] / p["group_device_s"]["k3"]
