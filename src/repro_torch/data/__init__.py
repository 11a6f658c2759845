"""The reference's seeded synthetic corpus, host-side numpy.

Copies of the reference's ``data/{synthetic,features,chunking,loader}.py``
under the same public names: the same utterance id gives the same audio,
alignment, features and batches, byte for byte, in either package.
Tensors enter at the trainer boundary (``launch/steps.py``).
"""
from repro_torch.data.synthetic import SynthConfig, Utterance, synth_corpus, synth_utterance
from repro_torch.data.features import FeatureConfig, featurize, featurize_utterance
from repro_torch.data.chunking import chunk_utterances, pad_batch
from repro_torch.data.loader import CorpusLoader, speaker_hash

__all__ = [
    "SynthConfig", "Utterance", "synth_corpus", "synth_utterance",
    "FeatureConfig", "featurize", "featurize_utterance",
    "chunk_utterances", "pad_batch", "CorpusLoader", "speaker_hash",
]
