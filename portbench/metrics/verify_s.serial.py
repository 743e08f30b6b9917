"""The client's seconds to check one attestation, where the cell keeps no
end-to-end ``verify_s``: all verify wall time of the window over the
attestations verified, the same reading as ``verify_s``."""


def read(run):
    return run.total("verify_s") / len(run.cycles)
