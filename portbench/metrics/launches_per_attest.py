"""Device kernels launched by one attestation (the profiled one of a
``--trace 1`` run), from torch.profiler's trace."""


def read(run):
    if run.profile is None:
        return None
    return run.profile["attest"]["launches"]
