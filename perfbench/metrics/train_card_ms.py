"""The card's milliseconds a training step: the union of its kernels,
copies and sets over a traced pass of the mix's `trace_steps` steps after
the window (the card's activity and the host's CUDA calls only), over
their count. The time a step takes where the host keeps the card fed;
idle gaps between the card's operations are not in it."""

CARD_TRACE = True


def read(run):
    if run.card is None:
        return None
    return 1e3 * run.card["busy_s"] / run.trace_count
