"""host_reads_per_flush: the enactor's host reads
(``repro_torch.core.enactor.host_reads``) over the window, per flush."""


def read(rec):
    if not rec["flushes"]:
        return None
    return rec["host_reads"] / len(rec["flushes"])
