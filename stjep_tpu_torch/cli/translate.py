"""Inference CLI of the port: the root translate.py's flag surface,
verbatim, on stjep_tpu_torch (no JAX).

    python -m stjep_tpu_torch.cli.translate --test_path_src SRC \\
        --test_acous_path FLIS --load CKPT --test_path_out OUT \\
        --eval_mode 1 --gen_mode ST --beam_width 5 (see --help)

Eval modes (ref: translate.py:443-459):
    1 - translate the test set to <test_path_out>/translate.txt (beam search)
    2 - average the checkpoints under --combine_path and save the combined
        model to <combine_path>-combine/combine
    3 - gather the mean dynamic embedding -> <test_path_out>/dyn_emb_ave.npy
        (the EMB_DYN_AVE artifact consumed by MT training / ST_BASE decode)
    4 - dump dynamic-vs-static embeddings to a TensorBoard projector (ref:
        translate.py:200-283 plot_emb); skipped where torch.utils.tensorboard
        cannot be imported

It runs on the card: `main(argv, device="cpu")` lets a caller (the CPU
tests) run it on the host, and without a visible card and without that
argument it raises instead of decoding on the CPU. `--use_gpu` is
accepted and, as in the JAX CLI, changes nothing. The checkpoint is read
as JAX's CLI reads it (its `model_config`, an `init_seq2seq` template, and
`upgrade_params` for an older layout); the decode kernels are f32, so a
bf16 checkpoint decodes from an f32 copy, as the Trainer's dev eval does.
`--lm_mode s-4g_<alpha>` reads `--lm_path` with dill where it is
importable, else with pickle (a pickled dict reads with either): a
{"entries", "backoffs"} dict builds the hashed n-gram table on the card
(infer/lm_table.py), any other object (with .logscore) is fused on the
host (infer/lm_fusion.py). The JAX CLI's `_FWD_CACHE` keeps jitted decode
programs across calls; the port traces nothing, so it has no counterpart.
"""

import argparse
import dataclasses
import os
import pickle
import sys
import time
from collections import deque

import numpy as np
import torch

from stjep_tpu_torch.config import ModelConfig, save_config, validate_config
from stjep_tpu_torch.utils.profiling import span


def load_arguments(parser):
    """ref: translate.py:25-53 — flag names preserved."""
    parser.add_argument('--test_path_src', type=str, required=True, help='test src dir')
    parser.add_argument('--test_path_tgt', type=str, default='None', help='test tgt dir')
    parser.add_argument('--path_vocab_src', type=str, default='None', help='vocab src dir, no need')
    parser.add_argument('--path_vocab_tgt', type=str, default='None', help='vocab tgt dir, not needed')
    parser.add_argument('--use_type', type=str, default='char', help='use char | word level prediction')
    parser.add_argument('--acous_norm', type=str, default='False', help='input acoustic fbk normalisation')
    parser.add_argument('--acous_norm_path', type=str, default='None', help='acoustics norm')
    parser.add_argument('--test_acous_path', type=str, default='None', help='test set acoustics')

    parser.add_argument('--load', type=str, required=True, help='model load dir')
    parser.add_argument('--combine_path', type=str, default='None', help='combine multiple ckpts if given dir')
    parser.add_argument('--test_path_out', type=str, required=True, help='test out dir')

    parser.add_argument('--max_seq_len', type=int, default=32, help='maximum sequence length')
    parser.add_argument('--batch_size', type=int, default=64, help='batch size')
    parser.add_argument('--beam_width', type=int, default=0, help='beam width; set to 0 to disable beam search')
    parser.add_argument('--use_gpu', type=str, default='False', help='whether or not using GPU')
    parser.add_argument('--eval_mode', type=int, default=2, help='which evaluation mode to use')
    parser.add_argument('--gen_mode', type=str, default='ASR', help='AE|ASR|MT|ST[-REF|-HYP]')
    parser.add_argument('--lm_mode', type=str, default='null', help='null|s-4g|s-rnn|d')
    parser.add_argument('--seqrev', type=str, default=False, help='whether or not to reverse sequence')
    parser.add_argument('--lm_path', type=str, default='None',
        help='path to pickled n-gram LM (the reference hardcodes its LM dir, '
             'ref: translate.py:88-93). A .logscore object decodes via a '
             'host callback; a {"entries": {(ids...): logp}, "backoffs": '
             '{...}} dict builds an on-device hashed table (no host sync)')
    parser.add_argument('--beam_cache_dtype', type=str, default='float32',
        help='decode dtype: float32 (token-identical to the reference) | '
             'bfloat16 (~1.5x faster; the KV cache AND the staged acoustic '
             'features are bf16, so hypotheses may flip near-ties)')
    parser.add_argument('--weight_dtype', type=str, default='float32',
        choices=['float32', 'int8'],
        help='decoder weight-streaming dtype for the fused beam kernels: '
             'float32 (line-identical to the reference) | int8 (serving-'
             'latency mode — per-output-channel quantized weights quarter '
             'the per-step weight HBM reads that dominate small-batch '
             'decode; hypotheses may differ from the f32 oracle)')
    parser.add_argument('--feat_dtype', type=str, default='auto',
        choices=['auto', 'float32', 'bfloat16', 'int8'],
        help='acoustic-feature staging dtype: auto (follows '
             '--beam_cache_dtype) | float32 | bfloat16 | int8. int8 stages '
             'per-utterance-quantized features and dequantizes on device — '
             '4x fewer host->device bytes than f32 (the dominant transfer '
             'on bandwidth-limited hosts); quantization step is ~amax/127, '
             'far below the CMVN feature noise floor, but near-tie '
             'hypotheses may flip vs float32')
    return parser


def _f32_on(params, device):
    """params with every floating leaf in f32, on `device`."""
    from stjep_tpu_torch.train.policies import map_with_path

    return map_with_path(params, lambda _, t: (t.float() if t.is_floating_point() else t)
                         .to(device))


def _load_model(load_dir, device="cuda"):
    """(cfg, params on `device` in f32, checkpoint) from a checkpoint dir
    with model_config in its meta (translate.py:74-98)."""
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.train.checkpoint import Checkpoint, upgrade_params

    raw = Checkpoint.load(load_dir)
    if raw.model_config is None:
        raise ValueError(f"checkpoint at {load_dir} has no model_config metadata")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in raw.model_config.items() if k in fields})
    template = init_seq2seq(cfg, torch.Generator().manual_seed(0))
    try:
        ckpt = Checkpoint.load(load_dir, params_template=template)
        params = ckpt.params
    except (KeyError, ValueError):
        # older checkpoint layout: overlay what matches, keep fresh values
        # for anything missing (the check_var analog, see upgrade_params)
        params = upgrade_params(raw.params, template)
        ckpt = raw
    return cfg, _f32_on(params, device), ckpt


def _lm_fuser(lm_model, lm_mode, device):
    """The LM fuser of a loaded LM (translate.py:124-138): an explicit
    ngram export {entries: {(ids...): logp}, backoffs: {...}} becomes the
    hashed probe table on `device` (no per-step host sync); any other
    object keeps the host fuser."""
    from stjep_tpu_torch.infer.lm_fusion import make_ngram_fuser
    from stjep_tpu_torch.infer.lm_table import NGramTable, make_table_fuser

    if isinstance(lm_model, dict) and "entries" in lm_model:
        table = NGramTable.from_ngrams(
            {tuple(k): v for k, v in lm_model["entries"].items()},
            {tuple(k): v for k, v in (lm_model.get("backoffs") or {}).items()},
            device=device)
        return make_table_fuser(table, lm_mode)
    return make_ngram_fuser(lm_model, lm_mode)


def _on(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`; to a card through pinned memory with a
    non-blocking copy (ordered on the stream before the decode reads it)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _acous_window(item, st, ed):
    """A minibatch's features padded to its bucketed length: round_up8 of
    its longest utterance, in buckets of 256 frames."""
    from stjep_tpu_torch.ops.masks import bucket_length, round_up8

    alen = bucket_length(int(round_up8(int(max(item['acouslen'][st:ed])))), 256)
    v = item['acous_feat'][st:ed]
    if alen > v.shape[1]:
        v = np.pad(v, [(0, 0), (0, alen - v.shape[1]), (0, 0)])
    return np.ascontiguousarray(v[:, :alen])


def stage(item, st, ed, gen_mode, refen, feat_dtype, cache_dtype, device):
    """Rows st:ed of a materialised batch as mode 1 stages them on
    `device`: the features (bucketed; f32, bf16, or int8 quantized on the
    host with per-utterance scales, bf16 where cache_dtype is), their
    lengths, and the source ids for MT and the refen modes. Returns the
    keyword arguments `unstage` turns into forward_translate's inputs."""
    from stjep_tpu_torch.data.device_cache import quantize_batch

    device = torch.device(device)
    kwargs = {}
    if 'acous_feat' in item:
        v = _acous_window(item, st, ed)
        if feat_dtype == 'int8':
            # quantized here: 4x fewer host-to-device bytes than f32
            packed = quantize_batch(v, np.float32)
            scale = torch.from_numpy(packed['scale'])
            if cache_dtype is not None:
                scale = scale.to(torch.bfloat16)
            kwargs['acous_q'] = _on(torch.from_numpy(packed['q']), device)
            kwargs['acous_scale'] = _on(scale, device)
        else:
            t = torch.from_numpy(v)
            if feat_dtype == 'bfloat16':  # halves the host-to-device copy
                t = t.to(torch.bfloat16)
            kwargs['acous_feats'] = _on(t, device)
        kwargs['acous_lens'] = _on(torch.from_numpy(item['acouslen'][st:ed]), device)
    if gen_mode == 'MT' or refen:
        kwargs['src'] = _on(torch.from_numpy(item['srcid'][st:ed]), device)
    return kwargs


def unstage(acous_q=None, acous_scale=None, **kw):
    """forward_translate's inputs from `stage`'s: int8 features
    dequantized on their device, and every feature dtype widened to f32
    (exactly: JAX's mixed-dtype product promotes bf16 features so)."""
    from stjep_tpu_torch.data.device_cache import dequantize

    if acous_q is not None:
        kw['acous_feats'] = dequantize(acous_q, acous_scale)
    if 'acous_feats' in kw:
        kw['acous_feats'] = kw['acous_feats'].float()
    return kw


def hyp_lines(preds, test_set, gen_mode, seqrev=False):
    """translate.txt's lines of a decoded minibatch (numpy ids): target
    characters after BOS for MT and the ST modes, source words for ASR."""
    from stjep_tpu_torch.utils.misc import _convert_to_words_batchfirst, detok_words

    if gen_mode == 'MT' or 'ST' in gen_mode:
        seqlist, id2word, use_type = preds[:, 1:], test_set.tgt_id2word, 'char'
    else:  # ASR
        seqlist, id2word, use_type = preds, test_set.src_id2word, 'word'
    return [detok_words(row, use_type=use_type, seqrev=seqrev)
            for row in _convert_to_words_batchfirst(seqlist, id2word)]


def translate(test_set, cfg, params, test_path_out, max_seq_len, beam_width,
              seqrev=False, gen_mode='ASR', lm_mode='null', lm_model=None,
              history='HYP', minibatch_size=None, logger_print=print,
              beam_cache_dtype='float32', feat_dtype='auto',
              weight_dtype='float32', device="cuda"):
    """MODE 1: beam-decode the test set to translate.txt (ref:
    translate.py:56-197). Minibatches are staged on a prefetch thread
    (`stage`: pinned non-blocking copies), STJEP_DECODE_PIPELINE (default
    4) of them ahead and as many decodes' results in flight before their
    rows are read back and written (0: inline, no thread);
    STJEP_TRANSLATE_TIMING=1 prints the seconds of each phase; each phase
    is also the span `stjep.translate.<phase>` (utils/profiling.py).
    Returns the output path."""
    from stjep_tpu_torch.data.loader import host_prefetch
    from stjep_tpu_torch.infer.forward import forward_translate

    device = torch.device(device)
    beam_width = max(1, beam_width)
    refen = history == 'REF'
    # LAS decode length override at eval time (ref: translate.py:72-73)
    if 'ASR' in gen_mode or 'ST' in gen_mode:
        cfg = dataclasses.replace(cfg, max_seq_len_src=150)
    lm_fuse = _lm_fuser(lm_model, lm_mode, device)
    cache_dtype = torch.bfloat16 if beam_cache_dtype == 'bfloat16' else None
    # 'auto' follows the decode dtype
    if feat_dtype in (None, 'auto'):
        feat_dtype = 'bfloat16' if cache_dtype is not None else 'float32'
    if feat_dtype not in ('float32', 'bfloat16', 'int8'):
        raise ValueError(f"feat_dtype {feat_dtype!r}")
    if weight_dtype not in ('float32', 'int8'):
        raise ValueError(f"weight_dtype {weight_dtype!r}")

    def fwd(kwargs):
        return forward_translate(
            params, cfg, gen_mode, beam_width=beam_width, penalty_factor=1.0,
            max_seq_len=max_seq_len, refen=refen, lm_fuse=lm_fuse,
            cache_dtype=cache_dtype,
            weight_dtype=None if weight_dtype == 'float32' else weight_dtype,
            device=device, **unstage(**kwargs))

    test_set.construct_batches(is_train=False)
    os.makedirs(test_path_out, exist_ok=True)
    out_path = os.path.join(test_path_out, 'translate.txt')
    n_batches = len(test_set)
    logger_print('num batches: {}'.format(n_batches))

    def _stage(item):
        """Slice a macro batch into minibatches and place them on the
        device (on the prefetch thread, so npy I/O and the host-to-device
        copies overlap the decode of earlier minibatches)."""
        B = item['srcid'].shape[0]
        mb = minibatch_size or B
        return [stage(item, st, min(st + mb, B), gen_mode, refen, feat_dtype,
                      cache_dtype, device) for st in range(0, B, mb)]

    def _write(preds, f):
        for line in hyp_lines(preds, test_set, gen_mode, seqrev):
            f.write('{}\n'.format(line))
        sys.stdout.flush()

    depth = max(0, int(os.environ.get('STJEP_DECODE_PIPELINE', '4')))
    timing = os.environ.get('STJEP_TRANSLATE_TIMING') == '1'
    phase = {'materialise': 0.0, 'stage': 0.0, 'dispatch': 0.0,
             'drain': 0.0, 'write': 0.0}

    spans = {k: 'stjep.translate.' + k for k in phase}

    def _timed(key, fn, *a):
        with span(spans[key]):
            if not timing:
                return fn(*a)
            t0 = time.perf_counter()
            out = fn(*a)
            phase[key] += time.perf_counter() - t0
            return out

    def _minibatches():
        for idx in range(n_batches):
            logger_print(idx + 1, n_batches)
            item = _timed('materialise', test_set.materialise_batch, idx)
            yield from _timed('stage', _stage, item)

    def _drain(f):
        time1 = time.time()
        preds = _timed('drain', lambda t: t.cpu().numpy(), pending.popleft())
        logger_print('comp time: ', time.time() - time1)
        _timed('write', _write, preds, f)

    # depth 0: no prefetch thread, fully inline
    stream = _minibatches() if depth == 0 else host_prefetch(_minibatches(), size=depth)
    pending = deque()
    with open(out_path, 'w', encoding='utf8') as f:
        for kwargs in stream:
            pending.append(_timed('dispatch', fwd, kwargs))
            if len(pending) >= max(depth, 1):
                _drain(f)
        while pending:
            _drain(f)
    if timing:
        print('translate phases (s):', {k: round(v, 2) for k, v in phase.items()}, flush=True)
    return out_path


@torch.no_grad()
def gather_emb(test_set, cfg, params, test_path_out, logger_print=print, device="cuda"):
    """MODE 3: mean dynamic embedding -> dyn_emb_ave.npy (ref:
    translate.py:286-357): the LAS teacher-forced on each batch's source
    (K1, then K9's forward on the card), the mean over all token slots of
    a batch, and the mean over batches."""
    from stjep_tpu_torch.models.seq2seq import _encoder_acous
    from stjep_tpu_torch.ops.masks import bucket_length

    device = torch.device(device)
    test_set.construct_batches(is_train=False)
    os.makedirs(test_path_out, exist_ok=True)
    lis = []
    for idx in range(len(test_set)):
        logger_print(idx + 1, len(test_set))
        item = test_set.materialise_batch(idx)
        B = item['srcid'].shape[0]
        # trim src to the batch's max length (the reference slices
        # src_ids[:, :src_len], ref: translate.py:122), bucketed as JAX does
        slen = min(bucket_length(int(max(item['srclen'])), 32), item['srcid'].shape[1])
        emb = _encoder_acous(
            params, cfg, _on(torch.from_numpy(_acous_window(item, 0, B)), device),
            _on(torch.from_numpy(item['acouslen']), device),
            tgt=_on(torch.from_numpy(np.ascontiguousarray(item['srcid'][:, :slen])), device),
            teacher_forcing=True, want_logps=False)[0]
        # mean over all token slots (ref: translate.py:351)
        lis.append(emb.reshape(-1, emb.shape[-1]).mean(dim=0).cpu().numpy())
    emb_ave = np.mean(np.stack(lis, axis=0), axis=0)
    path_out = os.path.join(test_path_out, 'dyn_emb_ave.npy')
    np.save(path_out, emb_ave)
    logger_print('saved to {}'.format(path_out))
    return path_out


@torch.no_grad()
def select_emb_rows(test_set, cfg, params, item, device="cuda"):
    """The rows mode 4 projects, from one materialised batch: the free-
    running LAS's dynamic embeddings and the static embeddings of the
    reference source at every real token slot (translate.py:363-384).
    Returns {"dyn", "static" [N, E], "hyp_ids", "ref_ids" [N], "words"
    (hypothesis words, then reference words)}."""
    from stjep_tpu_torch.models.las_decoder import embed
    from stjep_tpu_torch.models.seq2seq import _encoder_acous, _pre_proc_src
    from stjep_tpu_torch.ops.masks import round_up8

    device = torch.device(device)
    alen = min(int(round_up8(int(max(item['acouslen'])))), item['acous_feat'].shape[1])
    dyn, _, preds, _ = _encoder_acous(
        params, cfg, _on(torch.from_numpy(np.ascontiguousarray(item['acous_feat'][:, :alen])),
                         device),
        _on(torch.from_numpy(item['acouslen']), device), max_seq_len=cfg.max_seq_len_src)
    src = _pre_proc_src(torch.from_numpy(item['srcid']))
    static = embed(params['enc_embedder'], src.to(device))
    commlen = min(dyn.shape[1], static.shape[1])
    mask = np.arange(commlen)[None, :] < (np.asarray(item['srclen']) - 1)[:, None]
    out = {"dyn": dyn.cpu().numpy()[:, :commlen][mask],
           "static": static.cpu().numpy()[:, :commlen][mask],
           "hyp_ids": preds.cpu().numpy()[:, :commlen][mask],
           "ref_ids": src.numpy()[:, :commlen][mask]}
    out["words"] = [test_set.src_id2word.get(int(i), '<unk>')
                    for i in np.concatenate([out["hyp_ids"], out["ref_ids"]])]
    return out


def plot_emb(test_set, cfg, params, test_path_out, logger_print=print, device="cuda"):
    """MODE 4: TensorBoard projector dump of dynamic vs static embeddings
    of the first batch (ref: translate.py:200-283); None where
    torch.utils.tensorboard cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger_print('tensorboard unavailable; skipping plot_emb')
        return None

    writer = SummaryWriter(log_dir=test_path_out)
    test_set.construct_batches(is_train=False)
    rows = select_emb_rows(test_set, cfg, params, test_set.materialise_batch(0), device)
    dyn_sel, stat_sel = rows["dyn"], rows["static"]
    # static embeddings may be narrower than dynamic; project is for viz only
    if stat_sel.shape[1] != dyn_sel.shape[1]:
        pad = np.zeros((stat_sel.shape[0], dyn_sel.shape[1] - stat_sel.shape[1]))
        stat_sel = np.concatenate([stat_sel, pad], axis=1)
    writer.add_embedding(torch.tensor(np.concatenate([dyn_sel, stat_sel], axis=0)),
                         metadata=rows["words"])
    writer.close()
    logger_print('embedding projector written to {}'.format(test_path_out))
    return test_path_out


def _load_lm(lm_path):
    """The pickled LM at lm_path, read with dill where it is importable."""
    try:
        import dill as loader
    except ImportError:
        loader = pickle
    with open(lm_path, 'rb') as fin:
        return loader.load(fin)


def parse_config(argv=None):
    """translate.py's flags in argv (sys.argv[1:] when None), validated."""
    parser = argparse.ArgumentParser(description='Evaluation')
    parser = load_arguments(parser)
    return validate_config(vars(parser.parse_args(argv)))


def build_test_set(config, ckpt):
    """The test set main() decodes: config's paths in the checkpoint's
    vocabularies (translate.py:100-117)."""
    from stjep_tpu_torch.data.dataset import Dataset

    test_acous_path = config['test_acous_path']
    return Dataset(
        path_src=config['test_path_src'],
        path_tgt=config['test_path_tgt'] or config['test_path_src'],
        vocab_src_list=ckpt.input_vocab, vocab_tgt_list=ckpt.output_vocab,
        use_type=config['use_type'],
        acous_path=test_acous_path,
        seqrev=config['seqrev'],
        acous_norm=config['acous_norm'],
        acous_norm_path=config['acous_norm_path'],
        acous_max_len=6000, max_seq_len_src=900, max_seq_len_tgt=900,
        batch_size=config['batch_size'],
        mode='ST' if test_acous_path else 'MT',
    )


def main(argv=None, device="cuda"):
    """Parse argv (sys.argv[1:] when None) and run the eval mode on
    `device`. Returns what the mode returns: mode 1 the translate.txt
    path, mode 2 the combined checkpoint's dir, mode 3 the .npy path,
    mode 4 the projector dir or None."""
    from stjep_tpu_torch.train.checkpoint import Checkpoint, combine_weights, log_ckpts

    config = parse_config(argv)
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port's translate CLI runs "
                           "on the card (main(argv, device='cpu') runs it on the host)")

    test_path_out = config['test_path_out']

    MODE = config['eval_mode']
    if MODE != 2:
        os.makedirs(test_path_out, exist_ok=True)
        save_config(config, os.path.join(test_path_out, 'eval.cfg'))

    cfg, params, ckpt = _load_model(config['load'], device)
    print('Model dir: {}'.format(config['load']))
    print('Model loaded')

    if config['combine_path'] is not None:
        params = combine_weights(config['combine_path'], params_template=params)
        if MODE != 2:
            params = _f32_on(params, device)

    test_set = build_test_set(config, ckpt)
    print('Test dir: {}'.format(config['test_path_src']))
    print('Testset loaded')
    sys.stdout.flush()

    # '{AE|ASR|MT|ST}-{REF|HYP}' (ref: translate.py:431-437)
    parts = config['gen_mode'].split('-')
    gen_mode = parts[0]
    history = parts[1] if len(parts) == 2 else 'HYP'

    lm_model = None
    lm_mode = config['lm_mode']
    if lm_mode != 'null' and lm_mode is not None:
        if lm_mode.split('_')[0] != 's-4g':
            # fail loudly like the reference (assert False for s-rnn, ref:
            # translate.py:94-96): decoding with no fusion would
            # misattribute the scores to the requested LM
            raise NotImplementedError(
                f"lm_mode {lm_mode!r}: only 'null' and 's-4g[_alpha]' are "
                "supported (the reference's s-rnn/d branches are "
                "non-functional too)")
        if config['lm_path'] is None:
            raise ValueError('--lm_path required for s-4g')
        lm_model = _load_lm(config['lm_path'])
        print('LM {} - {} loaded'.format(lm_mode, config['lm_path']))

    if MODE == 1:
        return translate(test_set, cfg, params, test_path_out,
                         config['max_seq_len'], config['beam_width'],
                         seqrev=config['seqrev'], gen_mode=gen_mode,
                         lm_mode=lm_mode, lm_model=lm_model, history=history,
                         beam_cache_dtype=config['beam_cache_dtype'],
                         feat_dtype=config['feat_dtype'],
                         weight_dtype=config['weight_dtype'], device=device)
    if MODE == 2:
        if not config['combine_path']:
            raise ValueError("--eval_mode 2 (checkpoint combine/average) requires "
                             "--combine_path <dir of checkpoints>")
        out = Checkpoint(params=params, opt_state=None, epoch=0, step=0,
                         input_vocab=test_set.vocab_src, output_vocab=test_set.vocab_tgt,
                         model_config=ckpt.model_config)
        # rstrip, not strip: the reference's strip('/') turns absolute paths
        # relative (ref: translate.py:454)
        combined = config['combine_path'].rstrip('/') + '-combine'
        saved_path = out.save_customise(os.path.join(combined, 'combine'))
        log_ckpts(config['combine_path'], combined)
        print('saving at {} ... '.format(saved_path))
        return saved_path
    if MODE == 3:
        return gather_emb(test_set, cfg, params, test_path_out, device=device)
    if MODE == 4:
        return plot_emb(test_set, cfg, params, test_path_out, device=device)
    raise ValueError(f"--eval_mode {MODE}: 1, 2, 3 or 4")


if __name__ == '__main__':
    main()
