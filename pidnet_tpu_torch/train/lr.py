"""Poly learning-rate schedule (counterpart of pidnet_tpu/train/lr.py;
reference utils/utils.py:154-160): lr = base_lr * (1 - cur_iter/max_iters)
** power, applied per iteration."""


def poly_lr(base_lr: float, max_iters: int, cur_iter: int, power: float = 0.9) -> float:
    # clamp at 0: cur_iter can pass max_iters when a run trains past
    # END_EPOCH, and a negative base to a fractional power is complex
    return base_lr * (max(0.0, 1.0 - float(cur_iter) / max_iters) ** power)
