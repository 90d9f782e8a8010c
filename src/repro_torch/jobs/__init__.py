"""Tabular job-cost datasets (the paper's simulation substrate)."""

from repro_torch.jobs.tables import DeviceTables, JobTable
from repro_torch.jobs.synthetic import (synthetic_job, tensorflow_jobs,
                                        scout_jobs, cherrypick_jobs, all_jobs)

__all__ = ["DeviceTables", "JobTable", "synthetic_job", "tensorflow_jobs",
           "scout_jobs", "cherrypick_jobs", "all_jobs"]
