"""Engine stage 3, the layer proofs: EngineReport prove_seconds
summed over the window's attests over their number."""


def read(run):
    return run.mean("prove_s")
