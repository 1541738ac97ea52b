"""Local-file loaders for the text datasets. Counterpart of
``paddle_tpu/text/datasets/real.py``, whose code this is (numpy and the
standard library only).

A loader reads only files already on disk under ``$PADDLE_TPU_DATA_HOME``
(default ``~/.cache/paddle_tpu``), in the layouts of upstream Paddle's
datasets (``python/paddle/text/datasets/``), and returns None when they
are absent; nothing is downloaded.
"""
import os
import re
import tarfile

import numpy as np

DATA_HOME = os.environ.get(
    'PADDLE_TPU_DATA_HOME', os.path.expanduser('~/.cache/paddle_tpu'))


def data_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def load_uci_housing(mode='train', split=0.8):
    """housing.data: whitespace-separated floats, 13 features + MEDV target.
    Returns (x, y) float32 arrays or None when the file is absent."""
    path = data_path('uci_housing', 'housing.data')
    if not os.path.exists(path):
        return None
    raw = np.loadtxt(path).astype(np.float32)
    feats, target = raw[:, :-1], raw[:, -1:]
    # feature-wise (x - avg) / (max - min) over the FULL dataset, matching
    # the reference loader (uci_housing.py feature_range over whole matrix)
    n_train = int(len(raw) * split)
    mx = feats.max(axis=0)
    mn = feats.min(axis=0)
    avg = feats.mean(axis=0)
    feats = (feats - avg) / np.maximum(mx - mn, 1e-6)
    if mode == 'train':
        return feats[:n_train], target[:n_train]
    return feats[n_train:], target[n_train:]


_TOKENIZE = re.compile(r"[a-z]+|[^a-z\s]")


def _tokenize(line):
    return _TOKENIZE.findall(line.lower())


def load_imdb(mode='train', cutoff=150):
    """aclImdb_v1.tar.gz: pos/neg review text -> (word-id docs, labels).

    Builds the word dict from the train split with frequency cutoff.
    Single streaming pass over the tarball: token lists are kept per split
    and id-converted at the end (the archive is ~80MB gz — decompressing it
    repeatedly per construction would dominate load time).
    """
    path = data_path('imdb', 'aclImdb_v1.tar.gz')
    if not os.path.exists(path):
        return None
    pat = re.compile(r'aclImdb/(train|test)/(pos|neg)/.*\.txt$')
    freq = {}
    token_docs, labels = [], []
    with tarfile.open(path) as tf:
        for m in tf:
            mm = pat.match(m.name)
            if not mm:
                continue
            toks = _tokenize(tf.extractfile(m).read().decode(
                'utf-8', 'ignore'))
            # dict counts BOTH splits (reference imdb.py word_dict pattern
            # covers train|test), keeping ids compatible with the reference
            for w in toks:
                freq[w] = freq.get(w, 0) + 1
            if mm.group(1) == mode:
                token_docs.append(toks)
                labels.append(0 if mm.group(2) == 'pos' else 1)
    word_idx = {w: i for i, (w, c) in enumerate(
        sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])))
        if c >= cutoff}
    unk = len(word_idx)
    docs = [np.array([word_idx.get(w, unk) for w in toks], dtype=np.int64)
            for toks in token_docs]
    return docs, np.asarray(labels, np.int64), word_idx


def _imikolov_dict_from(tf, min_word_freq):
    """Word dict from the open tarball's ptb.train.txt. Follows the
    reference imikolov.py: lines wrapped with <s>/<e> markers before
    counting, words kept when freq > min_word_freq (strict), <unk> last."""
    freq = {}
    f = tf.extractfile('./simple-examples/data/ptb.train.txt')
    for line in f.read().decode('utf-8').splitlines():
        for w in ['<s>'] + line.strip().split() + ['<e>']:
            freq[w] = freq.get(w, 0) + 1
    freq = {w: c for w, c in freq.items()
            if c > min_word_freq and w != '<unk>'}
    word_idx = {w: i for i, (w, c) in enumerate(
        sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])))}
    word_idx['<unk>'] = len(word_idx)
    return word_idx


def load_imikolov_dict(min_word_freq=50):
    path = data_path('imikolov', 'simple-examples.tgz')
    if not os.path.exists(path):
        return None
    with tarfile.open(path) as tf:
        return _imikolov_dict_from(tf, min_word_freq)


def load_imikolov(mode='train', data_type='NGRAM', window_size=5,
                  min_word_freq=50):
    """PTB ngrams/sequences from simple-examples.tgz, or None if absent.

    NGRAM: windows over <s> line <e>; SEQ: (src, trg) = (<s>+ids, ids+<e>)
    pairs, both per the reference imikolov.py. One decompression pass: the
    dict is built from the same open tarball as the data read.
    """
    path = data_path('imikolov', 'simple-examples.tgz')
    if not os.path.exists(path):
        return None
    fname = ('./simple-examples/data/ptb.train.txt' if mode == 'train'
             else './simple-examples/data/ptb.valid.txt')
    data = []
    with tarfile.open(path) as tf:
        word_idx = _imikolov_dict_from(tf, min_word_freq)
        unk = word_idx['<unk>']
        f = tf.extractfile(fname)
        for line in f.read().decode('utf-8').splitlines():
            words = ['<s>'] + line.strip().split() + ['<e>']
            ids = [word_idx.get(w, unk) for w in words]
            if data_type.upper() == 'NGRAM':
                if len(ids) >= window_size:
                    for i in range(window_size, len(ids) + 1):
                        data.append(np.array(ids[i - window_size:i],
                                             dtype=np.int64))
            else:
                src = np.array(ids[:-1], dtype=np.int64)
                trg = np.array(ids[1:], dtype=np.int64)
                data.append((src, trg))
    return data


# ---------------------------------------------------------------------------
# Machine translation: WMT14 (shrunk set) and WMT16 (Multi30k)
# ---------------------------------------------------------------------------

_WMT_START, _WMT_END, _WMT_UNK = '<s>', '<e>', '<unk>'
_WMT14_UNK_IDX = 2


def load_wmt14(mode='train', dict_size=30000):
    """wmt14.tgz (reference dataset/wmt14.py layout: members ending in
    src.dict / trg.dict plus train/train, test/test, gen/gen tab-separated
    parallel text). Returns (pairs, src_dict, trg_dict) or None when absent;
    pairs are (src_ids, trg_ids, trg_ids_next) int64 arrays with the
    reference's <s>/<e> wrapping and the >80-token filter."""
    path = data_path('wmt14', 'wmt14.tgz')
    if not os.path.exists(path):
        return None
    member = {'train': 'train/train', 'test': 'test/test',
              'gen': 'gen/gen'}[mode]

    def to_dict(f, size):
        d = {}
        for i, line in enumerate(f):
            if i >= size:
                break
            d[line.strip().decode('utf-8')] = i
        return d

    pairs = []
    with tarfile.open(path) as tf:
        src_name = [m.name for m in tf if m.name.endswith('src.dict')][0]
        trg_name = [m.name for m in tf if m.name.endswith('trg.dict')][0]
        src_dict = to_dict(tf.extractfile(src_name), dict_size)
        trg_dict = to_dict(tf.extractfile(trg_name), dict_size)
        data_names = [m.name for m in tf if m.name.endswith(member)]
        for name in data_names:
            for line in tf.extractfile(name):
                parts = line.decode('utf-8', 'ignore').strip().split('\t')
                if len(parts) != 2:
                    continue
                src_ids = [src_dict.get(w, _WMT14_UNK_IDX)
                           for w in [_WMT_START] + parts[0].split() +
                           [_WMT_END]]
                trg = [trg_dict.get(w, _WMT14_UNK_IDX)
                       for w in parts[1].split()]
                if len(src_ids) > 80 or len(trg) > 80:
                    continue
                pairs.append((
                    np.array(src_ids, np.int64),
                    np.array([trg_dict[_WMT_START]] + trg, np.int64),
                    np.array(trg + [trg_dict[_WMT_END]], np.int64)))
    return pairs, src_dict, trg_dict


def _wmt16_build_dict(tf, dict_size, lang):
    """Freq-sorted dict from wmt16/train with <s>/<e>/<unk> at ids 0/1/2
    (reference wmt16.py __build_dict; tie-break by word for determinism)."""
    col = 0 if lang == 'en' else 1
    freq = {}
    for line in tf.extractfile('wmt16/train'):
        parts = line.decode('utf-8', 'ignore').strip().split('\t')
        if len(parts) != 2:
            continue
        for w in parts[col].split():
            freq[w] = freq.get(w, 0) + 1
    words = [_WMT_START, _WMT_END, _WMT_UNK]
    for w, c in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(words) >= dict_size:
            break
        words.append(w)
    return {w: i for i, w in enumerate(words)}


def load_wmt16(mode='train', src_dict_size=10000, trg_dict_size=10000,
               src_lang='en'):
    """wmt16.tar.gz (Multi30k; reference dataset/wmt16.py layout: members
    wmt16/train, wmt16/test, wmt16/val with en<TAB>de lines). Returns
    (pairs, src_dict, trg_dict) or None; pairs as in load_wmt14 (no length
    filter, per the reference)."""
    path = data_path('wmt16', 'wmt16.tar.gz')
    if not os.path.exists(path):
        return None
    member = {'train': 'wmt16/train', 'test': 'wmt16/test',
              'val': 'wmt16/val'}[mode]
    src_col = 0 if src_lang == 'en' else 1
    pairs = []
    with tarfile.open(path) as tf:
        src_dict = _wmt16_build_dict(tf, src_dict_size, src_lang)
        trg_dict = _wmt16_build_dict(
            tf, trg_dict_size, 'de' if src_lang == 'en' else 'en')
        start, end, unk = (src_dict[_WMT_START], src_dict[_WMT_END],
                           src_dict[_WMT_UNK])
        for line in tf.extractfile(member):
            parts = line.decode('utf-8', 'ignore').strip().split('\t')
            if len(parts) != 2:
                continue
            src_ids = [start] + [src_dict.get(w, unk)
                                 for w in parts[src_col].split()] + [end]
            trg = [trg_dict.get(w, unk) for w in parts[1 - src_col].split()]
            pairs.append((np.array(src_ids, np.int64),
                          np.array([start] + trg, np.int64),
                          np.array(trg + [end], np.int64)))
    return pairs, src_dict, trg_dict


# ---------------------------------------------------------------------------
# Conll05 SRL
# ---------------------------------------------------------------------------

def _conll05_parse_props(labels):
    """One predicate's prop column -> BIO tags (reference conll05.py
    corpus_reader bracket-walk)."""
    cur, inside, out = 'O', False, []
    for l in labels:
        if l == '*':
            out.append('I-' + cur if inside else 'O')
        elif l == '*)':
            out.append('I-' + cur)
            inside = False
        elif '(' in l and ')' in l:
            cur = l[1:l.find('*')]
            out.append('B-' + cur)
            inside = False
        elif '(' in l:
            cur = l[1:l.find('*')]
            out.append('B-' + cur)
            inside = True
        else:
            raise ValueError('unexpected SRL label: %r' % l)
    return out


def load_conll05_dicts():
    """wordDict.txt / verbDict.txt / targetDict.txt under conll05/, or None.
    Label dict is built B-*/I-* interleaved then O last, like the
    reference's load_label_dict."""
    base = data_path('conll05')
    paths = [os.path.join(base, n) for n in
             ('wordDict.txt', 'verbDict.txt', 'targetDict.txt')]
    if not all(os.path.exists(p) for p in paths):
        return None

    def load_dict(p):
        with open(p) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    word_dict, verb_dict = load_dict(paths[0]), load_dict(paths[1])
    tags = []
    with open(paths[2]) as f:
        for line in f:
            line = line.strip()
            if line.startswith(('B-', 'I-')) and line[2:] not in tags:
                tags.append(line[2:])
    # B-t/I-t get adjacent ids per tag type, O last (the reference's
    # load_label_dict layout; iteration order here is first-appearance,
    # deterministic, where the reference iterates an unordered set)
    label_dict = {}
    for t in tags:
        label_dict['B-' + t] = len(label_dict)
        label_dict['I-' + t] = len(label_dict)
    label_dict['O'] = len(label_dict)
    return word_dict, verb_dict, label_dict


def load_conll05(words_name='conll05st-release/test.wsj/words/test.wsj.words.gz',
                 props_name='conll05st-release/test.wsj/props/test.wsj.props.gz'):
    """conll05st-tests.tar.gz + dict files -> SRL samples, or None.

    Each sample mirrors the reference reader_creator's 9 slots:
    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark,
    label_ids) — the five ctx features are the predicate+-2 window words
    broadcast over the sentence, mark flags the window positions.
    """
    import gzip
    path = data_path('conll05', 'conll05st-tests.tar.gz')
    dicts = load_conll05_dicts()
    if not os.path.exists(path) or dicts is None:
        return None
    word_dict, verb_dict, label_dict = dicts
    unk = 0
    samples = []
    def emit(sentence, seg):
        """One sample per predicate of a finished sentence."""
        if not seg:
            return
        cols = list(zip(*seg))         # transpose to per-column
        verbs = [v for v in cols[0] if v != '-']
        for i, col in enumerate(cols[1:]):
            tags = _conll05_parse_props(col)
            v_idx = tags.index('B-V')
            n = len(sentence)
            mark = [0] * n
            ctx = []
            for off, fallback in ((-2, 'bos'), (-1, 'bos'), (0, None),
                                  (1, 'eos'), (2, 'eos')):
                j = v_idx + off
                if 0 <= j < n:
                    mark[j] = 1
                    ctx.append(sentence[j])
                else:
                    ctx.append(fallback)
            word_ids = [word_dict.get(w, unk) for w in sentence]
            ctx_ids = [[word_dict.get(c, unk)] * n for c in ctx]
            samples.append(tuple(
                np.array(a, np.int64) for a in (
                    [word_ids] + ctx_ids +
                    [[verb_dict.get(verbs[i], unk)] * n,
                     mark,
                     [label_dict[t] for t in tags]])))

    with tarfile.open(path) as tf:
        with gzip.GzipFile(fileobj=tf.extractfile(words_name)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(props_name)) as pf:
            sentence, seg = [], []
            for wline, pline in zip(wf, pf):
                word = wline.decode('utf-8').strip()
                props = pline.decode('utf-8').strip().split()
                if props:
                    sentence.append(word)
                    seg.append(props)
                    continue
                emit(sentence, seg)    # sentence boundary
                sentence, seg = [], []
            emit(sentence, seg)        # corpus without a trailing blank line
    return samples


# ---------------------------------------------------------------------------
# Movielens ml-1m
# ---------------------------------------------------------------------------

def load_movielens(mode='train', test_ratio=0.1, rand_seed=0):
    """ml-1m.zip (reference dataset/movielens.py: ratings/users/movies .dat
    with :: separators). Returns (features, meta) or None.

    features: list of (user_id, gender, age_idx, job_id, movie_id,
    category_ids, title_ids, rating) — ints/int64 arrays + float32 rating;
    meta: dict with category/title vocabularies. The train/test split uses
    a seeded RNG draw per rating row like the reference's __reader__.
    """
    import random as _random
    import zipfile
    path = data_path('movielens', 'ml-1m.zip')
    if not os.path.exists(path):
        return None
    ages = {'1': 0, '18': 1, '25': 2, '35': 3, '45': 4, '50': 5, '56': 6}
    categories, title_vocab = {}, {}
    movies, users = {}, {}
    with zipfile.ZipFile(path) as z:
        with z.open('ml-1m/movies.dat') as f:
            for line in f.read().decode('latin1').splitlines():
                mid, title, cats = line.strip().split('::')
                cat_ids = [categories.setdefault(c, len(categories))
                           for c in cats.split('|')]
                tit_ids = [title_vocab.setdefault(w.lower(), len(title_vocab))
                           for w in title.split()]
                movies[mid] = (int(mid), np.array(cat_ids, np.int64),
                               np.array(tit_ids, np.int64))
        with z.open('ml-1m/users.dat') as f:
            for line in f.read().decode('latin1').splitlines():
                uid, gender, age, job, _zip = line.strip().split('::')
                users[uid] = (int(uid), 0 if gender == 'M' else 1,
                              ages.get(age, 0), int(job))
        rng = _random.Random(rand_seed)
        feats = []
        with z.open('ml-1m/ratings.dat') as f:
            for line in f.read().decode('latin1').splitlines():
                uid, mid, rating, _ts = line.strip().split('::')
                is_test = rng.random() < test_ratio
                if is_test != (mode == 'test'):
                    continue
                if uid not in users or mid not in movies:
                    continue
                u = users[uid]
                m = movies[mid]
                feats.append(u + m + (np.float32(rating),))
    meta = {'categories': categories, 'title_vocab': title_vocab,
            'n_users': max(u[0] for u in users.values()) + 1,
            'n_movies': max(m[0] for m in movies.values()) + 1}
    return feats, meta


# ---------------------------------------------------------------------------
# MQ2007 (LETOR 4.0 learning-to-rank)
# ---------------------------------------------------------------------------

def load_mq2007(mode='pointwise', path_name='Querylevelnorm.txt'):
    """LETOR MQ2007 querylevelnorm lines (reference dataset/mq2007.py):
    ``rel qid:Q 1:v 2:v ... 46:v #docid = ...``. Returns samples per mode,
    or None when the file is absent:

    - pointwise: (relevance, feature[46]) per document;
    - pairwise: (label=1, feat_hi, feat_lo) for every in-query document
      pair with differing relevance (higher first, the reference's
      C(n,2) full partial order);
    - listwise: (relevance_list, feature_matrix) per query.
    """
    path = data_path('mq2007', path_name)
    if not os.path.exists(path):
        return None
    queries = {}
    order = []
    with open(path) as f:
        for line in f:
            body = line.split('#', 1)[0].strip()
            if not body:
                continue
            parts = body.split()
            rel = int(parts[0])
            qid = int(parts[1].split(':')[1])
            feat = np.zeros(46, np.float32)
            for p in parts[2:]:
                k, v = p.split(':')
                feat[int(k) - 1] = float(v)
            if qid not in queries:
                queries[qid] = []
                order.append(qid)
            queries[qid].append((rel, feat))
    return mq2007_samples((queries[qid] for qid in order), mode)


def mq2007_samples(query_groups, mode):
    """[(rel, feat[46])] per query -> mode-specific samples; the single
    implementation of the pointwise/pairwise/listwise generators (shared
    by the real loader and the synthetic fallback)."""
    out = []
    for docs in query_groups:
        if mode == 'pointwise':
            out.extend((np.int64(rel), feat) for rel, feat in docs)
        elif mode == 'pairwise':
            for i in range(len(docs)):
                for j in range(i + 1, len(docs)):
                    ri, fi = docs[i]
                    rj, fj = docs[j]
                    if ri == rj:
                        continue
                    hi, lo = (fi, fj) if ri > rj else (fj, fi)
                    out.append((np.int64(1), hi, lo))
        elif mode == 'listwise':
            out.append((np.asarray([r for r, _ in docs], np.int64),
                        np.stack([f for _, f in docs])))
        else:
            raise ValueError("mq2007 mode must be pointwise/pairwise/"
                             "listwise, got %r" % mode)
    return out


# ---------------------------------------------------------------------------
# Sentiment (NLTK movie_reviews layout)
# ---------------------------------------------------------------------------

_SENTIMENT_CORPUS = {}   # base path -> (per_file, freq); tokenizing 2000
                         # reviews is the expensive part, do it once


def _sentiment_corpus(base, test_ratio):
    key = (base, test_ratio)
    if key in _SENTIMENT_CORPUS:
        return _SENTIMENT_CORPUS[key]
    freq = {}
    per_file = []
    for label, cat in ((0, 'pos'), (1, 'neg')):
        cat_dir = os.path.join(base, cat)
        if not os.path.isdir(cat_dir):
            return None
        for i, fname in enumerate(sorted(os.listdir(cat_dir))):
            with open(os.path.join(cat_dir, fname), errors='ignore') as f:
                toks = _tokenize(f.read())
            for w in toks:
                freq[w] = freq.get(w, 0) + 1
            is_test = (i % int(round(1 / test_ratio)) == 0)
            per_file.append((toks, label, is_test))
    _SENTIMENT_CORPUS[key] = (per_file, freq)
    return per_file, freq


def load_sentiment(mode='train', cutoff=0, test_ratio=0.1):
    """movie_reviews/{pos,neg}/*.txt (reference dataset/sentiment.py via
    NLTK). Returns (docs, labels, word_idx) or None; label 0 = pos,
    1 = neg (the reference's ordering). Deterministic round-robin split:
    every 10th file per class is held out for test. The parsed corpus is
    cached so train+test loads tokenize the files once."""
    base = data_path('sentiment', 'movie_reviews')
    if not os.path.isdir(base):
        return None
    corpus = _sentiment_corpus(base, test_ratio)
    if corpus is None:
        return None
    per_file, freq = corpus
    word_idx = {w: i for i, (w, c) in enumerate(
        sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])))
        if c >= cutoff}
    unk = len(word_idx)
    docs, labels = [], []
    want_test = (mode == 'test')
    for toks, label, is_test in per_file:
        if is_test != want_test:
            continue
        docs.append(np.asarray([word_idx.get(w, unk) for w in toks],
                               np.int64))
        labels.append(label)
    return docs, np.asarray(labels, np.int64), word_idx
