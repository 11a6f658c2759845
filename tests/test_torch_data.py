"""The port's copy of the synthetic corpus (``repro_torch/data``) against
the reference's: the same utterance ids and configs give equal arrays
(``np.array_equal``, dtypes included) from the synthesizer, the feature
frontend with its running-CMN carry, the chunked and full-sequence
batches, and the speaker hash."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro.data import features as jfeatures  # noqa: E402
from repro_torch import data as pdata  # noqa: E402
from repro_torch.data import features as pfeatures  # noqa: E402

SYNTH = dict(n_speakers=6, n_senones=41, mean_utt_sec=0.8, seed=3)


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    assert np.array_equal(a, b), what


def _pair():
    return (jdata.SynthConfig(**SYNTH), pdata.SynthConfig(**SYNTH))


@pytest.mark.parametrize("utt_id", [0, 7, 10_003])
def test_synth_utterance_matches(utt_id):
    jc, pc = _pair()
    ju, pu = jdata.synth_utterance(jc, utt_id), pdata.synth_utterance(pc,
                                                                     utt_id)
    for f in ("utt_id", "speaker", "device", "snr_db", "n_frames"):
        assert getattr(ju, f) == getattr(pu, f), f
    for f in ("audio", "senones", "phones"):
        _same(getattr(ju, f), getattr(pu, f), f)


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_featurize_utterance_with_the_cmn_carry(offset):
    """Two utterances of one speaker in a row, the second starting from
    the first's running mean; with a global MVN and a look-ahead."""
    jc, pc = _pair()
    jfc, pfc = jdata.FeatureConfig(n_mels=16), pdata.FeatureConfig(n_mels=16)
    jus = [jdata.synth_utterance(jc, i) for i in (1, 2)]
    pus = [pdata.synth_utterance(pc, i) for i in (1, 2)]
    jmvn = jfeatures.GlobalMVN.estimate(
        [jdata.featurize(u.audio, jfc)[0] for u in jus])
    pmvn = pfeatures.GlobalMVN.estimate(
        [pdata.featurize(u.audio, pfc)[0] for u in pus])
    _same(jmvn.mean, pmvn.mean, "mvn mean")
    _same(jmvn.std, pmvn.std, "mvn std")
    jcarry = pcarry = None
    for ju, pu in zip(jus, pus):
        jf, jl, jcarry = jdata.featurize_utterance(
            ju, jfc, offset=offset, mvn=jmvn, carry_mean=jcarry, lookahead=1)
        pf, pl, pcarry = pdata.featurize_utterance(
            pu, pfc, offset=offset, mvn=pmvn, carry_mean=pcarry, lookahead=1)
        _same(jf, pf, "feats")
        _same(jl, pl, "labels")
        _same(jcarry, pcarry, "carry")


def _loaders(n_workers=1, worker=0):
    jc, pc = _pair()
    jl = jdata.CorpusLoader(synth=jc, feat=jdata.FeatureConfig(n_mels=16),
                            worker=worker, n_workers=n_workers)
    pl = pdata.CorpusLoader(synth=pc, feat=pdata.FeatureConfig(n_mels=16),
                            worker=worker, n_workers=n_workers)
    _same(jl.estimate_mvn(4).mean, pl.estimate_mvn(4).mean)
    return jl, pl


def _same_batches(jbs, pbs):
    assert len(jbs) == len(pbs) > 0
    for jb, pb in zip(jbs, pbs):
        assert sorted(jb) == sorted(pb)
        for k in jb:
            _same(jb[k], pb[k], k)


@pytest.mark.parametrize("offset,seed", [(0, 0), (2, 5)])
def test_chunked_batches_match(offset, seed):
    jl, pl = _loaders()
    kw = dict(batch_size=3, chunk_len=8, offset=offset, seed=seed)
    _same_batches(list(jl.chunked_batches(0, 6, **kw)),
                  list(pl.chunked_batches(0, 6, **kw)))


def test_full_seq_batches_match():
    jl, pl = _loaders(n_workers=2, worker=1)
    _same_batches(list(jl.full_seq_batches(0, 10, batch_size=2)),
                  list(pl.full_seq_batches(0, 10, batch_size=2)))
    _same_batches(list(jl.full_seq_batches(0, 10, batch_size=2,
                                           max_len=20)),
                  list(pl.full_seq_batches(0, 10, batch_size=2,
                                           max_len=20)))


def test_speaker_hash_matches():
    for n in (1, 2, 7, 64):
        assert [jdata.speaker_hash(s, n) for s in range(200)] == \
            [pdata.speaker_hash(s, n) for s in range(200)]


def test_public_names_match():
    assert pdata.__all__ == jdata.__all__


def test_published_widths_match():
    """One utterance at the published widths (3,183 senones, 64 mels):
    the port's codebooks, built once per senone count, give the
    reference's audio and features."""
    jc = jdata.SynthConfig(n_senones=3183, seed=1)
    pc = pdata.SynthConfig(n_senones=3183, seed=1)
    for uid in (2, 3):
        ju, pu = jdata.synth_utterance(jc, uid), pdata.synth_utterance(pc,
                                                                       uid)
        _same(ju.audio, pu.audio, "audio")
        _same(ju.senones, pu.senones, "senones")
        jf = jdata.featurize_utterance(ju, jdata.FeatureConfig())
        pf = pdata.featurize_utterance(pu, pdata.FeatureConfig())
        for a, b in zip(jf, pf):
            _same(a, b)
        assert pf[0].shape[1] == 192
