"""The port's data pipeline (``repro_torch.data``) against the reference's
(``repro.data``), on the CPU: both are numpy, so every batch must be
bitwise the reference's for each (seed, step, host_index, host_count),
for the dense, vlm (``patch_embeds``) and audio ([B, S, C] codebooks)
streams, the memory-mapped token file, and through the prefetch thread.
"""
import numpy as np
import pytest

from repro_torch.data import MemmapLM, Prefetcher, SyntheticLM

#: (vocab, batch, seq, seed, n_codebooks, n_img_tokens, d_model)
STREAMS = {"dense": (256, 4, 32, 0, 0, 0, 0),
           "vlm": (256, 4, 32, 3, 0, 8, 64),
           "audio": (2048, 4, 16, 5, 4, 0, 0)}
#: (step, host_index, host_count)
KEYS = [(0, 0, 1), (7, 0, 1), (123456, 0, 1), (3, 1, 2), (3, 3, 4)]


@pytest.fixture(scope="module")
def rdata():
    pytest.importorskip("jax")
    from repro import data
    return data


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("family", sorted(STREAMS))
@pytest.mark.parametrize("key", KEYS, ids=lambda k: "s%d_h%d_of%d" % k)
def test_synthetic_bitwise(rdata, family, key):
    """SyntheticLM.get equals the reference's bitwise; labels are the
    next tokens, and a vlm batch carries [B, n, d] f32 patch embeddings."""
    args = STREAMS[family]
    step, hi, hc = key
    got = SyntheticLM(*args).get(step, host_index=hi, host_count=hc)
    _equal(got, rdata.SyntheticLM(*args).get(step, host_index=hi,
                                             host_count=hc))
    vocab, batch, seq, _, ncb, nimg, d = args
    shape = (batch // hc, seq) + ((ncb,) if ncb else ())
    assert got["tokens"].shape == shape and got["tokens"].max() < vocab
    if nimg:
        assert got["patch_embeds"].shape == (batch // hc, nimg, d)


def test_memmap_bitwise(rdata, tmp_path):
    """MemmapLM over a uint16 token file: the reference's windows,
    bitwise, for several steps and host shards."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    for step, hi, hc in KEYS:
        _equal(MemmapLM(str(path), 4, 64, seed=2).get(
                   step, host_index=hi, host_count=hc),
               rdata.MemmapLM(str(path), 4, 64, seed=2).get(
                   step, host_index=hi, host_count=hc))


def test_prefetcher_stream(rdata):
    """The prefetch thread yields consecutive steps from its start, each
    the reference source's batch for that step and host."""
    args = STREAMS["vlm"]
    pf = Prefetcher(SyntheticLM(*args), start_step=5, host_index=1,
                    host_count=2)
    try:
        for want_step in range(5, 9):
            step, batch = pf.next()
            assert step == want_step
            _equal(batch, rdata.SyntheticLM(*args).get(
                step, host_index=1, host_count=2))
    finally:
        pf.close()
    assert not pf.t.is_alive()
