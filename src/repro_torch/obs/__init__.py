"""Observability of the port: the pinned Outcome fields and their diffs."""

from repro_torch.obs.forensics import (PINNED_OUTCOME_FIELDS, diff_outcomes,
                                       outcome_to_dict)

__all__ = ["PINNED_OUTCOME_FIELDS", "diff_outcomes", "outcome_to_dict"]
