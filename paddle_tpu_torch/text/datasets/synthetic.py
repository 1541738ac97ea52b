"""The text datasets: the real corpora from local files (``real``), else
deterministic synthetic sets. Counterpart of
``paddle_tpu/text/datasets/synthetic.py``, on the port's ``io.Dataset``.

The synthetic sets are the reference's arrays: each draws from a
``numpy.random.RandomState`` seeded by the ``crc32`` of its class name and
mode (not ``hash()``, which is salted per process), so both packages give
the same ids and labels.
"""
import numpy as np

from ...io import Dataset

__all__ = ['Imdb', 'Imikolov', 'Movielens', 'UCIHousing', 'WMT14', 'WMT16',
           'Conll05st', 'MQ2007', 'Sentiment']


class _SyntheticSeqDataset(Dataset):
    VOCAB = 5000
    SEQ = 128
    N_TRAIN = 2048
    N_TEST = 256
    NUM_CLASSES = 2

    def __init__(self, mode='train', **kwargs):
        import zlib
        # crc32, not hash(): str hashing is salted per process, and the
        # synthetic data must be identical across runs
        seed = zlib.crc32(
            ('%s:%s' % (type(self).__name__, mode)).encode()) % (2 ** 31)
        rng = np.random.RandomState(seed)
        n = self.N_TRAIN if mode == 'train' else self.N_TEST
        self.docs = rng.randint(1, self.VOCAB, size=(n, self.SEQ)).astype(
            np.int64)
        self.labels = rng.randint(0, self.NUM_CLASSES, size=n).astype(np.int64)
        self.synthetic = True

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imdb(_SyntheticSeqDataset):
    VOCAB = 5147

    def __init__(self, mode='train', cutoff=150, **kwargs):
        from . import real
        loaded = real.load_imdb(mode, cutoff)
        if loaded is not None:
            self.docs, self.labels, self.word_idx = loaded
            self.synthetic = False
            return
        super().__init__(mode, **kwargs)


class Imikolov(_SyntheticSeqDataset):
    """N-gram LM data: returns (context, next word)."""
    VOCAB = 2000
    SEQ = 5

    def __init__(self, mode='train', data_type='NGRAM', window_size=5,
                 min_word_freq=50, **kwargs):
        from . import real
        loaded = real.load_imikolov(mode, data_type, window_size,
                                    min_word_freq)
        if loaded is not None:
            self.docs = loaded
            self.synthetic = False
            return
        # synthetic n-grams must honor the requested window, or a model
        # built for n-grams gets wrong context widths
        self.SEQ = int(window_size)
        super().__init__(mode, **kwargs)

    def __getitem__(self, idx):
        seq = self.docs[idx]
        if isinstance(seq, tuple):      # real SEQ mode: (src, trg) pair
            return seq
        return seq[:-1], seq[-1:]


class Movielens(Dataset):
    """ml-1m ratings. Real loader (PADDLE_TPU_DATA_HOME/movielens/ml-1m.zip)
    yields full (uid, gender, age, job, movie, categories, title, rating)
    feature rows; the synthetic fallback keeps the 3-tuple shape."""

    def __init__(self, mode='train', test_ratio=0.1, rand_seed=0, **kwargs):
        from . import real
        loaded = real.load_movielens(mode, test_ratio, rand_seed)
        if loaded is not None:
            self.feats, self.meta = loaded
            self.synthetic = False
            return
        rng = np.random.RandomState(7 if mode == 'train' else 8)
        n = 4096 if mode == 'train' else 512
        self.users = rng.randint(0, 6040, n).astype(np.int64)
        self.movies = rng.randint(0, 3952, n).astype(np.int64)
        self.ratings = rng.randint(1, 6, n).astype(np.float32)
        self.synthetic = True

    def __getitem__(self, idx):
        if not self.synthetic:
            return self.feats[idx]
        return (self.users[idx], self.movies[idx], self.ratings[idx])

    def __len__(self):
        return len(self.feats) if not self.synthetic else len(self.users)


class UCIHousing(Dataset):
    def __init__(self, mode='train', **kwargs):
        from . import real
        loaded = real.load_uci_housing(mode)
        if loaded is not None:
            self.x, self.y = loaded
            self.synthetic = False
            return
        rng = np.random.RandomState(9 if mode == 'train' else 10)
        n = 404 if mode == 'train' else 102
        self.x = rng.randn(n, 13).astype(np.float32)
        w = np.linspace(-1, 1, 13).astype(np.float32)
        self.y = (self.x @ w + 0.1 * rng.randn(n)).astype(
            np.float32).reshape(-1, 1)
        self.synthetic = True

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


class WMT14(_SyntheticSeqDataset):
    """Translation pairs: (src_ids, trg_ids, trg_next_ids). Real loader
    reads PADDLE_TPU_DATA_HOME/wmt14/wmt14.tgz (reference wmt14.py layout)."""
    VOCAB = 30000
    SEQ = 32

    def __init__(self, mode='train', dict_size=30000, **kwargs):
        loaded = self._load_real(mode, dict_size, **kwargs)
        if loaded is not None:
            self.pairs, self.src_dict, self.trg_dict = loaded
            self.synthetic = False
            return
        # synthetic ids must respect the requested dict size, or a model
        # sized to it would gather out of bounds
        self.VOCAB = min(type(self).VOCAB, dict_size)
        super().__init__(mode, **kwargs)

    def _load_real(self, mode, dict_size, **kwargs):
        from . import real
        return real.load_wmt14(mode, dict_size)

    def __getitem__(self, idx):
        if not self.synthetic:
            return self.pairs[idx]
        src = self.docs[idx]
        trg = np.roll(src, 1)
        return src, trg, np.roll(trg, -1)

    def __len__(self):
        return len(self.pairs) if not self.synthetic else len(self.docs)


class WMT16(WMT14):
    """Multi30k en-de. Real loader reads
    PADDLE_TPU_DATA_HOME/wmt16/wmt16.tar.gz (reference wmt16.py layout)."""

    def __init__(self, mode='train', src_dict_size=10000,
                 trg_dict_size=10000, src_lang='en', **kwargs):
        self._cfg = (src_dict_size, trg_dict_size, src_lang)
        super().__init__(mode, dict_size=min(src_dict_size, trg_dict_size),
                         **kwargs)

    def _load_real(self, mode, dict_size, **kwargs):
        from . import real
        src_size, trg_size, src_lang = self._cfg
        return real.load_wmt16(mode, src_size, trg_size, src_lang)


class Conll05st(_SyntheticSeqDataset):
    """SRL. Real loader (PADDLE_TPU_DATA_HOME/conll05/) yields the
    reference's 9-slot samples (words, 5 ctx windows, predicate, mark,
    labels); synthetic fallback keeps the 3-tuple shape."""
    VOCAB = 44068
    SEQ = 64
    NUM_CLASSES = 67

    def __init__(self, mode='train', **kwargs):
        from . import real
        loaded = real.load_conll05()
        if loaded is not None:
            self.samples = loaded
            self.synthetic = False
            return
        super().__init__(mode, **kwargs)

    def __getitem__(self, idx):
        if not self.synthetic:
            return self.samples[idx]
        words = self.docs[idx]
        labels = (words % self.NUM_CLASSES).astype(np.int64)
        pred = words[:1]
        return words, pred, labels

    def __len__(self):
        return len(self.samples) if not self.synthetic else len(self.docs)


class MQ2007(Dataset):
    """LETOR MQ2007 learning-to-rank. Real loader reads
    PADDLE_TPU_DATA_HOME/mq2007/Querylevelnorm.txt; synthetic fallback
    generates query groups with a linear-in-features relevance rule.
    mode: pointwise | pairwise | listwise (reference mq2007.py gens)."""

    def __init__(self, mode='pointwise', **kwargs):
        from . import real
        loaded = real.load_mq2007(mode)
        if loaded is not None:
            self.samples = loaded
            self.synthetic = False
            return
        from .real import mq2007_samples
        rng = np.random.RandomState(11)
        w = rng.randn(46).astype(np.float32)
        groups = []
        for qid in range(64):
            n = rng.randint(4, 12)
            feats = rng.rand(n, 46).astype(np.float32)
            rel = np.clip((feats @ w / 4 + rng.randn(n) * 0.2) + 1, 0, 2) \
                .astype(np.int64)
            groups.append(list(zip(rel, feats)))
        self.samples = mq2007_samples(groups, mode)
        self.synthetic = True

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Sentiment(Dataset):
    """NLTK movie_reviews polarity. Real loader reads
    PADDLE_TPU_DATA_HOME/sentiment/movie_reviews/{pos,neg}/*.txt;
    label 0 = pos, 1 = neg (reference sentiment.py)."""
    VOCAB = 4000

    def __init__(self, mode='train', **kwargs):
        from . import real
        loaded = real.load_sentiment(mode)
        if loaded is not None:
            self.docs, self.labels, self.word_idx = loaded
            self.synthetic = False
            return
        rng = np.random.RandomState(13 if mode == 'train' else 14)
        n = 1024 if mode == 'train' else 128
        self.labels = rng.randint(0, 2, n).astype(np.int64)
        # class-dependent token distribution so models can learn
        self.docs = [rng.randint(lab * 100, self.VOCAB - (1 - lab) * 100,
                                 size=rng.randint(20, 120)).astype(np.int64)
                     for lab in self.labels]
        self.synthetic = True

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)
