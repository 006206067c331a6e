"""The port's synthetic data streams against the JAX package's: batches
byte-equal (every array: dtype, shape and bytes) for several (seed, step,
host, host_count), the LM stream's embeds / prefix_embeds branches
included."""
import pytest

from repro.config import ShapeSpec as JShape
from repro.configs import get_config as jget
from repro.data.pipeline import make_pipeline as jpipe
from repro_torch.config import ShapeSpec
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import (DataState, SyntheticCNN, SyntheticLM,
                                       make_pipeline)

GRID = [(0, 0, 0, 1), (3, 7, 1, 2), (11, 100_000, 3, 4), (2**31 - 1, 5, 0, 1)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,step,host,hosts", GRID)
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-14b"])
def test_lm_batches_are_byte_equal(arch, seed, step, host, hosts):
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    kw = dict(seed=seed, host_index=host, host_count=hosts)
    got = make_pipeline(tc, ShapeSpec("t", 24, 8, "train"), **kw)
    want = jpipe(jc, JShape("t", 24, 8, "train"), **kw)
    assert isinstance(got, SyntheticLM) and got.local_batch == 8 // hosts
    _equal(got.batch_at(step), want.batch_at(step))


@pytest.mark.parametrize("seed,step,host,hosts", GRID)
@pytest.mark.parametrize("arch", ["convnet-dbb", "lenet5-dbb"])
def test_cnn_batches_are_byte_equal(arch, seed, step, host, hosts):
    jc, tc = jget(arch), tget(arch)
    kw = dict(seed=seed, host_index=host, host_count=hosts)
    got = make_pipeline(tc, seed=seed, host_index=host, host_count=hosts,
                        cnn_batch=16)
    want = jpipe(jc, None, cnn_batch=16, **kw)
    assert isinstance(got, SyntheticCNN)
    _equal(got.batch_at(step), want.batch_at(step))


@pytest.mark.parametrize("fields", [dict(embeds_input=True),
                                    dict(prefix_embed_len=5),
                                    dict(embeds_input=True,
                                         prefix_embed_len=3)])
def test_embeds_branches_are_byte_equal(fields):
    """The audio (frame embeds) and vlm (prefix embeds, masked prefix
    labels) branches."""
    jc = jget("olmo-1b", smoke=True).replace(**fields)
    tc = tget("olmo-1b", smoke=True).replace(**fields)
    for step in (0, 9):
        _equal(make_pipeline(tc, ShapeSpec("t", 16, 4, "train"),
                             seed=5).batch_at(step),
               jpipe(jc, JShape("t", 16, 4, "train"), seed=5).batch_at(step))


def test_stateless_addressing_and_errors():
    """A batch depends on (seed, step, host) alone: reading out of order
    gives the same bytes; a batch that does not split raises."""
    tc = tget("olmo-1b", smoke=True)
    p = make_pipeline(tc, ShapeSpec("t", 8, 4, "train"), seed=1)
    a = p.batch_at(3)
    p.batch_at(0)
    _equal(a, p.batch_at(3))
    assert DataState() == DataState(step=0, seed=0)
    with pytest.raises(ValueError):
        SyntheticLM(tc, ShapeSpec("t", 8, 6, "train"), host_count=4)
    with pytest.raises(ValueError):
        make_pipeline(tc)
