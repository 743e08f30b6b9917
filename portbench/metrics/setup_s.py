"""Set-up seconds: the kernel libraries loaded (built on a checkout's
first run), the weights drawn, and the ModelCard published (weight
commitments and range proofs)."""


def read(run):
    return run.setup_s
