"""The paper tasks' configs and data (``repro_torch.configs.paper_tasks``,
``repro_torch.data.synthetic``) against the JAX package's.

Exact: every ``PaperTask`` field, ``train_config``, and the three
generators' output element for element (dense arrays, labels, split
points, and the scipy sparse matrices' shape, indices, indptr and data),
on several seeds and sizes."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from repro.configs import paper_tasks as j_tasks
from repro.data import synthetic as j_syn
from repro_torch.configs import paper_tasks as t_tasks
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic as t_syn


def _same_sparse(a: sp.csr_matrix, b: sp.csr_matrix) -> None:
    assert isinstance(a, sp.csr_matrix) and isinstance(b, sp.csr_matrix)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _same_array(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_paper_tasks_equal_the_reference():
    assert list(t_tasks.PAPER_TASKS) == list(j_tasks.PAPER_TASKS)
    names = [f.name for f in dataclasses.fields(t_tasks.PaperTask)]
    assert names == [f.name for f in dataclasses.fields(j_tasks.PaperTask)]
    for key, jt in j_tasks.PAPER_TASKS.items():
        tt = t_tasks.PAPER_TASKS[key]
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt), key


@pytest.mark.parametrize("name", sorted(j_tasks.PAPER_TASKS))
def test_train_config_equals_the_reference(name):
    tc = t_tasks.PAPER_TASKS[name].train_config(37)
    jc = j_tasks.PAPER_TASKS[name].train_config(37)
    assert isinstance(tc, TrainConfig)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name


@pytest.mark.parametrize("seed,n,d,mean_items", [
    (0, 300, 400, 5), (1, 257, 2400, 5), (7, 310, 1600, 18),
    (123456789, 300, 2000, 3)])
def test_make_recsys_equals_the_reference(seed, n, d, mean_items):
    t = t_syn.make_recsys(n=n, d=d, mean_items=mean_items, seed=seed)
    j = j_syn.make_recsys(n=n, d=d, mean_items=mean_items, seed=seed)
    assert (t.d, t.n, t.n_train) == (j.d, j.n, j.n_train)
    _same_array(t.p_in, j.p_in)
    _same_array(t.q_out, j.q_out)
    _same_sparse(t.X_in, j.X_in)
    _same_sparse(t.X_out, j.X_out)
    for tv, jv in zip(t.train() + t.test(), j.train() + j.test()):
        _same_array(tv, jv)


@pytest.mark.parametrize("seed,n,d,n_classes", [
    (0, 300, 500, 12), (3, 301, 4000, 12), (2**31 - 1, 300, 800, 5)])
def test_make_classification_equals_the_reference(seed, n, d, n_classes):
    t = t_syn.make_classification(n=n, d=d, n_classes=n_classes,
                                  mean_items=17, seed=seed)
    j = j_syn.make_classification(n=n, d=d, n_classes=n_classes,
                                  mean_items=17, seed=seed)
    _same_array(t[0], j[0])
    _same_array(t[1], j[1])
    assert t[2] == j[2]
    _same_sparse(t[3], j[3])


@pytest.mark.parametrize("seed,n,d,mean_len", [
    (0, 300, 300, 6), (5, 301, 2000, 10), (99, 300, 2000, 6)])
def test_make_sessions_equals_the_reference(seed, n, d, mean_len):
    t_seqs, t_n = t_syn.make_sessions(n_sessions=n, d=d, mean_len=mean_len,
                                      seed=seed)
    j_seqs, j_n = j_syn.make_sessions(n_sessions=n, d=d, mean_len=mean_len,
                                      seed=seed)
    _same_array(t_seqs, j_seqs)
    assert t_n == j_n


def test_pad_and_sparse_helpers_equal_the_reference():
    sets = [np.array([3, 1, 4]), np.array([1, 5, 9, 2, 6]), np.array([], int),
            np.array([7])]
    for c_max in (1, 3, 5, 8):
        _same_array(t_syn._pad_sets(sets, c_max), j_syn._pad_sets(sets, c_max))
    _same_sparse(t_syn._to_sparse(sets, 4, 10), j_syn._to_sparse(sets, 4, 10))


def test_token_stream_still_equals_the_reference():
    _same_array(t_syn.make_token_stream(1000, 97, seed=3),
                j_syn.make_token_stream(1000, 97, seed=3))
