"""repro_torch.analysis — the malleability sanitizer + lint subsystem (port
of ``repro.analysis``).

Two halves:

* :mod:`repro_torch.analysis.trail` — dynamic: a schedule-trail race
  detector over recorded ``dmr.Cluster`` trails (and simulator resize
  logs), attachable live as ``Cluster(sanitize=True)``.
* :mod:`repro_torch.analysis.lint` — static: an AST lint pass over
  ``dmr.App`` user code and ``Policy`` implementations (DMR101-DMR103,
  DMR105, DMR106).

CLI: ``python -m repro_torch.analysis lint|audit``.
"""
from repro_torch.analysis.lint import (LintFinding, lint_paths,  # noqa: F401
                                       lint_source)
from repro_torch.analysis.trail import (JobMeta, TrailAuditor,  # noqa: F401
                                        TrailViolation, Violation,
                                        audit_grant_log, audit_resize_log,
                                        audit_trail, audit_trail_file,
                                        dump_trail, job_metadata, load_trail)

__all__ = [
    "Violation", "TrailViolation", "JobMeta", "TrailAuditor",
    "audit_trail", "audit_grant_log", "audit_resize_log",
    "audit_trail_file", "dump_trail", "load_trail", "job_metadata",
    "LintFinding", "lint_source", "lint_paths",
]
