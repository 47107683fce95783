"""The card's published peaks, from `peaks.json`; None for a card the table does not hold."""

from __future__ import annotations


def of(rec: dict):
    return rec["spec"].peaks.get(rec["device_kind"])
