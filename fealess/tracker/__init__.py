"""KCF tracker family (reference kcf_tracker/, SURVEY.md §2.3)."""

from fealess.tracker.kcf import KcfTracker, KcfState  # noqa: F401
