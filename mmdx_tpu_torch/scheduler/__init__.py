"""Scheduling: daily pipeline commands + in-process periodic scheduler."""
