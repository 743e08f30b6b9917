"""Engine stage 2, the boundary commitments: EngineReport
commit_seconds summed over the window's attests over their number."""


def read(run):
    return run.mean("commit_s")
