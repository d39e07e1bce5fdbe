"""Seconds a matrix outside every phase of the phase file: FASTA, subject
set-up, planning, estimators, PHYLIP (the phase-file matrices' wall less
the sum of their phases)."""


def read(record):
    mats = record.get("phase_matrices")
    if not mats:
        return None
    return sum(m["wall_s"] - sum(s for _, s in m["phases"])
               for m in mats) / len(mats)
