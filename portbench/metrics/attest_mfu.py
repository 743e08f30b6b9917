"""The whole attestation's share of the card's INT32 peak: the modular
products that one attestation of the configuration needs
(portbench/cost.py ``attest_work``, from the configuration, seq and the
policy) over attest_s times cost.INT32_OPS_PER_S."""
from portbench import cost


def read(run):
    ops, _ = cost.attest_work(run.block, run.layers,
                              run.cell.traffic["pcs_blowup"])
    attest_s = run.total("attest_s") / len(run.cycles)
    return 100.0 * ops / (attest_s * cost.INT32_OPS_PER_S)
