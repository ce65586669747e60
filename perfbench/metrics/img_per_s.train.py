"""Crops of every step in the window, over its seconds; the window ends
when the last step's loss is read. The host's pace where it paces the
step; `train_card_ms` is the card's."""

from perfbench.harness.readers import rate as read  # noqa: F401
