"""The decoding stack: ``dynamic_decode``, ``BeamSearchDecoder``, the
decode helpers and ``BasicDecoder``, and the dense ``beam_search`` /
``beam_search_decode`` ops. Counterpart of ``paddle_tpu/nn/decode.py``.

The loop is the reference's: one probe step at t = 0 gives the outputs'
shapes, the outputs go into preallocated time-major ``[max_T, B, ...]``
buffers, and the loop stops when every sequence is finished or at
``max_step_num`` (256 when not given: the reference's fixed bound, a
documented divergence from upstream's unbounded loop, which the port
follows). The reference's ``while_loop`` becomes a Python loop here; each
step reads ``finished.all()`` on the host once (the only host read of the
loop), and after an early exit ``pad_buffers`` fills the unwritten steps.
``time`` is a Python int. Log-probabilities are fp32 whatever the logits'
dtype, and a finished beam extends only with ``end_token`` at no cost
(every other token at ``-_KINF``).
"""
import contextlib

import torch

from .functional.extension import gather_tree

__all__ = ['Decoder', 'BeamSearchDecoder', 'dynamic_decode', 'DecodeHelper',
           'TrainingHelper', 'GreedyEmbeddingHelper', 'SampleEmbeddingHelper',
           'BasicDecoder', 'beam_search', 'beam_search_decode']

_KINF = 1e9


def _map_structure(fn, *structs):
    """``fn`` over the tensor leaves of parallel nests of dicts, lists and
    tuples (namedtuples kept); ``None`` stays ``None``."""
    first = structs[0]
    if isinstance(first, dict):
        return {k: _map_structure(fn, *(s[k] for s in structs))
                for k in first}
    if isinstance(first, (list, tuple)):
        items = [_map_structure(fn, *parts) for parts in zip(*structs)]
        if hasattr(first, '_fields'):
            return type(first)(*items)
        return type(first)(items)
    if first is None:
        return None
    return fn(*structs)


def _one_hot_scores(n, index, device):
    """(n,) fp32: 0 at ``index``, ``-_KINF`` elsewhere, built on the
    device with no host write: a finished beam's next-token scores (only
    the end token), the first step's beam scores (only beam 0)."""
    return torch.where(torch.arange(n, device=device) == index, 0.0,
                       -_KINF).float()


def _flatten(struct):
    """The tensor leaves in the reference's order (dict keys sorted)."""
    if isinstance(struct, dict):
        return [x for k in sorted(struct) for x in _flatten(struct[k])]
    if isinstance(struct, (list, tuple)):
        return [x for s in struct for x in _flatten(s)]
    return [] if struct is None else [struct]


class Decoder:
    """The decoder interface: ``initialize``, ``step``, ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell(inputs, states) -> (logits, states)``.

    The cell sees ``[B * beam_size, ...]`` inputs and states; a
    batch-major tensor it reads from outside (an encoder's output) must be
    tiled by the caller with ``tile_beam_merge_with_batch``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...], each row repeated beam times."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _split_batch_beams(self, x):
        return x.reshape((x.shape[0] // self.beam_size, self.beam_size)
                         + tuple(x.shape[1:]))

    def _merge_batch_beams(self, x):
        return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

    def _expand_to_beam_size(self, x):
        """[B, ...] -> [B, beam, ...]."""
        return x[:, None].expand((x.shape[0], self.beam_size)
                                 + tuple(x.shape[1:]))

    def _gather(self, x, flat):
        """x [B, W, ...] -> x[b, indices[b, w]], ``flat`` the indices
        offset by each batch row's first beam (``b * W + indices``)."""
        return x.reshape((-1,) + tuple(x.shape[2:])).index_select(
            0, flat).reshape(x.shape)

    def initialize(self, initial_cell_states):
        state0 = _flatten(initial_cell_states)[0]
        batch, dev, W = state0.shape[0], state0.device, self.beam_size
        cell_states = _map_structure(self._expand_to_beam_size,
                                     initial_cell_states)
        init_ids = torch.full((batch, W), self.start_token,
                              dtype=torch.int64, device=dev)
        log_probs = _one_hot_scores(W, 0, dev).expand(batch, W).contiguous()
        finished = torch.zeros((batch, W), dtype=torch.bool, device=dev)
        lengths = torch.zeros((batch, W), dtype=torch.int64, device=dev)
        inputs = self.embedding_fn(init_ids) if self.embedding_fn \
            else init_ids
        states = {'cell_states': cell_states, 'log_probs': log_probs,
                  'finished': finished, 'lengths': lengths}
        return inputs, states, finished

    def _candidate_log_probs(self, logits, beam_state):
        """-> (B, W, V) fp32: each beam's score extended by each token (a
        finished beam only by ``end_token``), the scores the step's top-W
        selects from."""
        step_lp = torch.log_softmax(logits.float(), dim=-1)
        noend = _one_hot_scores(logits.shape[-1], self.end_token,
                                logits.device)
        step_lp = torch.where(beam_state['finished'][..., None], noend,
                              step_lp)
        return step_lp + beam_state['log_probs'][..., None]

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        W = self.beam_size
        vocab = logits.shape[-1]
        prev_fin = beam_state['finished']
        lp = self._candidate_log_probs(logits, beam_state)      # (B, W, V)
        scores, topk_idx = torch.topk(lp.reshape(lp.shape[0], W * vocab), W)
        beam_idx = topk_idx // vocab
        token_idx = topk_idx % vocab
        next_fin = torch.gather(prev_fin, 1, beam_idx)
        next_len = torch.gather(beam_state['lengths'], 1, beam_idx) + \
            (~next_fin).to(torch.int64)
        next_fin = next_fin | (token_idx == self.end_token)
        flat = (beam_idx + W * torch.arange(
            beam_idx.shape[0], device=beam_idx.device)[:, None]).reshape(-1)
        next_cell_states = _map_structure(
            lambda x: self._gather(x, flat), next_cell_states)
        output = {'scores': scores, 'predicted_ids': token_idx,
                  'parent_ids': beam_idx}
        state = {'cell_states': next_cell_states, 'log_probs': scores,
                 'finished': next_fin, 'lengths': next_len}
        return output, state

    def step(self, time, inputs, states, **kwargs):
        inputs = _map_structure(self._merge_batch_beams, inputs)
        cell_states = _map_structure(self._merge_batch_beams,
                                     states['cell_states'])
        cell_outputs, next_cell_states = self.cell(inputs, cell_states,
                                                   **kwargs)
        cell_outputs = _map_structure(self._split_batch_beams, cell_outputs)
        next_cell_states = _map_structure(self._split_batch_beams,
                                          next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        output, state = self._beam_search_step(time, cell_outputs,
                                               next_cell_states, states)
        sample_ids = output['predicted_ids']
        next_inputs = self.embedding_fn(sample_ids) if self.embedding_fn \
            else sample_ids
        return output, state, next_inputs, state['finished']

    def pad_buffers(self, buffers, t_final):
        """After an early exit at ``t_final``: the unwritten steps get
        ``end_token`` ids and identity parents, so that ``gather_tree``'s
        backtrace passes through them unchanged."""
        out = dict(buffers)
        ids, parents = buffers['predicted_ids'], buffers['parent_ids']
        out['predicted_ids'] = ids.clone()
        out['predicted_ids'][t_final:] = self.end_token
        out['parent_ids'] = parents.clone()
        out['parent_ids'][t_final:] = torch.arange(
            self.beam_size, dtype=parents.dtype, device=parents.device)
        return out

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrace the beam tree; ``outputs`` are time-major
        [T, B, W]."""
        return gather_tree(outputs['predicted_ids'],
                           outputs['parent_ids']), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every sequence is finished or for
    ``max_step_num`` steps (256 when None) -> ``(outputs, final_states)``
    and with ``return_length=True`` the lengths. The outputs span all
    ``max_step_num`` steps (the steps after an early exit padded by the
    decoder's ``pad_buffers``, where it has one), batch-major unless
    ``output_time_major``. ``is_test=True`` runs under ``no_grad``."""
    max_T = int(max_step_num) if max_step_num is not None else 256
    grad_ctx = torch.no_grad if is_test else contextlib.nullcontext
    with grad_ctx():
        inputs, states, initial_finished = decoder.initialize(inits)
        outputs, states, inputs, finished = decoder.step(0, inputs, states,
                                                         **kwargs)
        if not decoder.tracks_own_finished:
            finished = initial_finished | finished
        seq_len = (~initial_finished).to(torch.int64)

        def alloc(o):
            buf = o.new_zeros((max_T,) + tuple(o.shape))
            buf[0] = o
            return buf
        buffers = _map_structure(alloc, outputs)
        t = 1
        # the loop's one host read a step
        while t < max_T and not bool(finished.all()):
            outputs, next_states, inputs, next_finished = decoder.step(
                t, inputs, states, **kwargs)
            if not decoder.tracks_own_finished:
                next_finished = finished | next_finished
            seq_len = seq_len + (~finished).to(torch.int64)
            if impute_finished:
                fin = finished
                next_states = _map_structure(
                    lambda old, new: torch.where(
                        fin.reshape(tuple(fin.shape)
                                    + (1,) * (new.dim() - fin.dim())),
                        old.to(new.dtype), new),
                    states, next_states)

            def write(buf, o, t=t):
                buf[t] = o
                return buf
            buffers = _map_structure(write, buffers, outputs)
            states, finished = next_states, next_finished
            t += 1
    if decoder.tracks_own_finished and isinstance(states, dict) \
            and 'lengths' in states:
        seq_len = states['lengths']
    if hasattr(decoder, 'pad_buffers'):
        buffers = decoder.pad_buffers(buffers, t)
    try:
        final_outputs, states = decoder.finalize(buffers, states, seq_len)
    except NotImplementedError:
        final_outputs = buffers
    if not output_time_major:
        final_outputs = _map_structure(lambda x: x.transpose(0, 1),
                                       final_outputs)
    if return_length:
        return final_outputs, states, seq_len
    return final_outputs, states


class DecodeHelper:
    """The helper interface: ``initialize``, ``sample``, ``next_inputs``."""

    def initialize(self):
        raise NotImplementedError

    def sample(self, time, outputs, states):
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: step ``t`` reads the ground-truth input ``t``."""

    def __init__(self, inputs, sequence_length, time_major=False):
        self.inputs = inputs
        self.sequence_length = sequence_length
        self.time_major = time_major
        self._max_t = inputs.shape[0] if time_major else inputs.shape[1]

    def _at(self, t):
        return self.inputs[t] if self.time_major else self.inputs[:, t]

    def initialize(self):
        return self._at(0), self.sequence_length <= 0

    def sample(self, time, outputs, states):
        return outputs.argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        finished = (time + 1) >= self.sequence_length.clamp_max(self._max_t)
        return finished, self._at(min(time + 1, self._max_t - 1)), states


class GreedyEmbeddingHelper(DecodeHelper):
    """Greedy argmax sampling, then the embedding of the sampled ids."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = torch.as_tensor(start_tokens)
        self.end_token = int(end_token)

    def initialize(self):
        finished = torch.zeros(self.start_tokens.shape[0], dtype=torch.bool,
                               device=self.start_tokens.device)
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        return outputs.argmax(-1)

    def next_inputs(self, time, outputs, states, sample_ids):
        return (sample_ids == self.end_token,
                self.embedding_fn(sample_ids), states)


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Sampling from ``softmax(logits / softmax_temperature)`` with a
    ``torch.Generator`` on the logits' device, seeded with ``seed`` (the
    device's default generator when None); the reference draws from its
    JAX key, so the two sample different ids."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self.seed = seed
        self._gen = None

    def sample(self, time, outputs, states):
        logits = outputs if self.temperature is None \
            else outputs / self.temperature
        if self._gen is None and self.seed is not None:
            self._gen = torch.Generator(device=logits.device)
            self._gen.manual_seed(int(self.seed))
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, return_parent_idx=False):
    """One dense beam-search step: ``pre_ids``, ``pre_scores`` (B, W),
    ``scores`` (B, W, V) -> ``(selected_ids, selected_scores[,
    parent_idx])``, each (B, W). ``is_accumulated=False``: ``scores`` are
    probabilities, added to ``pre_scores`` as logs. A finished beam
    (``pre_ids == end_id``) carries ``end_id`` on at its frozen score.
    ``ids`` is not read, as in the reference."""
    W, end = int(beam_size), int(end_id)
    sc = scores.float()
    if not is_accumulated:
        sc = torch.log(sc) + pre_scores[..., None]
    noend = _one_hot_scores(sc.shape[-1], end, sc.device)
    sc = torch.where((pre_ids == end)[..., None],
                     noend + pre_scores[..., None], sc)
    vocab = sc.shape[-1]
    top_sc, top_idx = torch.topk(sc.reshape(sc.shape[0], W * vocab), W)
    parent, token = top_idx // vocab, top_idx % vocab
    if return_parent_idx:
        return token, top_sc, parent
    return token, top_sc


def beam_search_decode(ids, scores, beam_size, end_id):
    """Backtrace whole sequences: ``ids=(token_ids, parent_ids)``, each
    time-major (T, B, W) -> ``(sequences (T, B, W), scores)``."""
    token_ids, parent_ids = ids
    return gather_tree(token_ids, parent_ids), scores


class BasicDecoder(Decoder):
    """A cell, a helper and an optional output layer."""

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        initial_inputs, initial_finished = self.helper.initialize()
        return initial_inputs, initial_cell_states, initial_finished

    def step(self, time, inputs, states, **kwargs):
        cell_outputs, cell_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time, cell_outputs, cell_states)
        finished, next_inputs, next_states = self.helper.next_inputs(
            time, cell_outputs, cell_states, sample_ids)
        outputs = {'cell_outputs': cell_outputs, 'sample_ids': sample_ids}
        return outputs, next_states, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError
