"""The provider's seconds per attestation: all attest wall time of the
window (attest and the v2 wire encoding) over the attestations made."""


def read(run):
    return run.total("attest_s") / len(run.cycles)
