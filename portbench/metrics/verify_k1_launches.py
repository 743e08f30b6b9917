"""K1 (Poseidon2) launches per verify of the window, from the
program's exact launch counter."""


def read(run):
    return run.mean("verify_k1")
