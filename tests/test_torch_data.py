"""The port's data pipeline against the reference's: the same config and step
give the same batches bit for bit (synthetic and memmap sources, the
microbatch reshape, extras), and the prefetching iterator yields what
``get_batch`` returns."""
import numpy as np
import pytest

from repro.data import pipeline as jdp
from repro_torch.data import pipeline as dp

CASES = [
    dict(vocab=1000, seq_len=16, global_batch=4, seed=3),
    dict(vocab=257, seq_len=64, global_batch=8, seed=0),
    dict(vocab=64000, seq_len=512, global_batch=8, microbatches=4, seed=0),
    dict(vocab=100, seq_len=8, global_batch=8, microbatches=4),
    dict(vocab=100, seq_len=8, global_batch=2, extras={"patches": (4, 16)}),
    dict(vocab=512, seq_len=32, global_batch=4, microbatches=2, seed=11,
         extras={"frames": (32, 128)}),
]


def _equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("step", [0, 1, 7])
def test_synthetic_batches_equal_the_reference(case, step):
    kw = CASES[case]
    _equal(dp.get_batch(dp.DataConfig(**kw), step), jdp.get_batch(jdp.DataConfig(**kw), step))


def test_batches_are_step_indexed():
    cfg = dp.DataConfig(vocab=1000, seq_len=16, global_batch=4, seed=3)
    _equal(dp.get_batch(cfg, 7), dp.get_batch(cfg, 7))
    assert not np.array_equal(dp.get_batch(cfg, 7)["tokens"], dp.get_batch(cfg, 8)["tokens"])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_memmap_batches_equal_the_reference(tmp_path, microbatches):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1 << 20, 9 * 40, dtype=np.int32).tofile(path)
    kw = dict(vocab=5000, seq_len=8, global_batch=4, microbatches=microbatches,
              source="memmap", path=str(path), seed=2)
    for step in range(3):
        got = dp.get_batch(dp.DataConfig(**kw), step)
        _equal(got, jdp.get_batch(jdp.DataConfig(**kw), step))
    assert got["tokens"].shape == ((4, 9) if microbatches == 1 else (2, 2, 9))


def test_memmap_rows_are_contiguous_samples(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(9 * 40, dtype=np.int32).tofile(path)
    b = dp.get_batch(dp.DataConfig(vocab=1 << 30, seq_len=8, global_batch=4, source="memmap",
                                   path=str(path)), 0)
    assert b["tokens"].shape == (4, 9) and (np.diff(b["tokens"], axis=1) == 1).all()


def test_host_prefetch_agrees_with_get_batch():
    cfg = dp.DataConfig(vocab=100, seq_len=8, global_batch=4, microbatches=2, seed=5,
                        extras={"patches": (2, 4)})
    pf = dp.host_prefetch(cfg, start_step=3)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for step, batch in got:
        _equal(batch, dp.get_batch(cfg, step))
