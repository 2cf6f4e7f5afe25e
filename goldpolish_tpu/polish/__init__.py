"""Polishing editors: the exact oracle and the two-phase device engine."""


def polish_contig(seq: bytes, bf, cfg, backend: str = "numpy", bloomrep=None):
    """Route to the right editor: the two-phase engine for the standard modes,
    the exact oracle for SNV mode / secondary-BF runs (rare paths the
    batched engine doesn't accelerate)."""
    from . import ntedit_oracle

    if cfg.snv or bloomrep is not None:
        return ntedit_oracle.polish_contig(seq, bf, cfg, bloomrep)
    from .ntedit_tpu import NtEditTPU

    return NtEditTPU(cfg, bf, backend=backend).polish_contig(seq)
