"""repro_torch.analysis — the malleability sanitizer (port of the dynamic
half of ``repro.analysis``).

:mod:`repro_torch.analysis.trail` is a schedule-trail race detector over
recorded ``dmr.Cluster`` trails (and simulator resize logs), attachable
live as ``Cluster(sanitize=True)``.  The JAX package's static half (the
AST lint of ``dmr.App`` code and policies) and its CLI are not ported yet.
"""
from repro_torch.analysis.trail import (JobMeta, TrailAuditor,  # noqa: F401
                                        TrailViolation, Violation,
                                        audit_grant_log, audit_resize_log,
                                        audit_trail, audit_trail_file,
                                        dump_trail, job_metadata, load_trail)

__all__ = [
    "Violation", "TrailViolation", "JobMeta", "TrailAuditor",
    "audit_trail", "audit_grant_log", "audit_resize_log",
    "audit_trail_file", "dump_trail", "load_trail", "job_metadata",
]
