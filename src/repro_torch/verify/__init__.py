"""Rule-ID registry the codegen reason strings are tagged with.

Only :mod:`repro_torch.verify.rules` is ported; the standalone soundness
verifier itself is not part of this package yet.
"""
