"""PyTorch port: `metrics.confusion_matrix` on labels outside [0, C) against
the JAX package's `pidnet_tpu.metrics.confusion_matrix`, from the same
seeded numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pidnet_tpu import metrics as jmetrics
from pidnet_tpu_torch import metrics

torch.set_num_threads(2)

C = 5


def _labels_and_preds(seed: int = 6):
    """Seeded labels in [0, C) with C, C + 1 and 255 mixed in, and a
    class map to score."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, (2, 9, 7)).astype(np.int32)
    mask = rng.random(labels.shape)
    labels[mask < 0.1] = C
    labels[(mask >= 0.1) & (mask < 0.2)] = C + 1
    labels[(mask >= 0.2) & (mask < 0.3)] = 255
    preds = rng.integers(0, C, labels.shape).astype(np.int32)
    return labels, preds


@pytest.mark.parametrize("ignore", [-1, 255])
def test_labels_at_or_above_classes_are_dropped_as_jax_drops_them(ignore):
    """Labels C, C + 1 and 255, under ignore -1 (the configs' default) and
    under ignore 255: the port's matrix equals JAX's, and counts exactly
    the pixels whose label lies in [0, C)."""
    labels, preds = _labels_and_preds()
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), C,
                                                ignore))
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), C, ignore)
    assert got.dtype == torch.int64 and tuple(got.shape) == (C, C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((labels >= 0) & (labels < C)).sum())


def test_the_recorded_cases_of_the_fault():
    """Labels [0, 1, 2, 3, 255] against preds [0, 1, 2, 1, 0], C = 3,
    ignore -1: diag(1, 1, 1), as JAX gives (the port used to raise)."""
    labels = np.array([[0, 1, 2, 3, 255]], np.int32)
    preds = np.array([[0, 1, 2, 1, 0]], np.int32)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 3, -1))
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 3, -1)
    np.testing.assert_array_equal(got.numpy(), np.eye(3))
    np.testing.assert_array_equal(want, np.eye(3))


def test_negative_labels_are_dropped_where_jax_counts_them_in_cell_0_0():
    """A negative label that is not the ignore label is dropped by the
    port. JAX counts it in cell (0, 0), because `jnp.bincount` clips a
    negative index to 0: a recorded quirk of the reference (its numpy
    `bincount` raises on a negative index), not followed."""
    labels, preds = _labels_and_preds(7)
    labels[0, 0, :3] = -5
    preds[0, 0, :3] = [0, 2, 4]
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), C, 255))
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), C, 255)
    quirk = np.zeros((C, C), np.int64)
    quirk[0, 0] = 3
    np.testing.assert_array_equal(want - got.numpy(), quirk)
    assert int(got.sum()) == int(((labels >= 0) & (labels < C)).sum())
