"""The client's seconds to check one attestation: all verify wall
time of the window over the attestations verified."""


def read(run):
    return run.total("verify_s") / len(run.cycles)
