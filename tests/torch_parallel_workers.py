"""Ranks of the port's multi-process tests, and the spawner the tests
call. Imports torch and the port, never jax: each rank is its own
process, started by `spawn`, joined into a gloo group through a file
under the test's tmp_path (no port to race for under xdist).

    python tests/torch_parallel_workers.py CASE DIR RANK WORLD

reads DIR/in.npz (weights under "w/<model>/<key>", inputs) and
DIR/spec.json, runs CASE, and writes DIR/out<RANK>.npz (arrays, and
the non-array results as JSON under "json").
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240          # a spawn; a hung rank fails its test
GROUP_TIMEOUT_S = 120    # a collective that does not complete raises
SPAWN_LOCK = ".torch_parallel_spawn.lock"


@contextlib.contextmanager
def spawn_lock(tmp_path):
    """One spawn at a time across the run's xdist workers (their
    temporary directories share the parent of their base): the ranks'
    cores are not taken from the tests that wait on a wall clock."""
    with open(Path(tmp_path).resolve().parents[1] / SPAWN_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def spawn(case: str, tmp_path, world: int, inputs: dict, spec=None,
          env=None, expect_fail: bool = False):
    """Run CASE on `world` ranks; returns each rank's outputs (dicts of
    numpy arrays, "json" decoded). Fails with the ranks' output when a
    rank fails or the spawn outlives TIMEOUT_S. With expect_fail, returns
    each rank's (exit code, output) instead."""
    d = Path(tmp_path) / case
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "in.npz", **inputs)
    (d / "spec.json").write_text(json.dumps(spec or {}))
    child_env = dict(os.environ, OMP_NUM_THREADS="1",
                     PYTHONPATH=str(REPO), **(env or {}))
    with spawn_lock(tmp_path):
        procs = [subprocess.Popen(
            [sys.executable, __file__, case, str(d), str(r), str(world)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=child_env) for r in range(world)]
        deadline = time.monotonic() + TIMEOUT_S
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise AssertionError(f"{case}: ranks still running after "
                                 f"{TIMEOUT_S} s")
    if expect_fail:
        return [(p.returncode, log) for p, log in zip(procs, logs)]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r} failed:\n{log[-4000:]}"
    outs = []
    for r in range(world):
        with np.load(d / f"out{r}.npz") as f:
            o = {k: f[k] for k in f.files}
        o["json"] = json.loads(str(o["json"]))
        outs.append(o)
    return outs


# ---------------------------------------------------------------------------
# the ranks (torch and the port only)
# ---------------------------------------------------------------------------

def tp_cfg(heads: int, timestamp: bool = False, hotword: bool = False,
           vocab: int = 64):
    """tests/test_parallel.py's _tp_cfg (d 32, 2 + 2 blocks, vocab 64)
    in the port's config, heads = the tp it is sharded over."""
    from asr2pass_tpu_torch.config import (DecoderConfig, EncoderConfig,
                                           ParaformerConfig, PredictorConfig)

    d = 32
    return ParaformerConfig(
        encoder=EncoderConfig(input_size=560, output_size=d, num_blocks=2,
                              attention_heads=heads, linear_units=4 * d),
        decoder=DecoderConfig(num_blocks=2, attention_heads=heads,
                              linear_units=4 * d),
        predictor=PredictorConfig(idim=d, use_timestamp=timestamp),
        vocab_size=vocab, use_hotword=hotword)


def svs_cfg(heads: int, vocab: int = 64):
    """sensevoice_tiny (d 64, 2 blocks) with `heads` heads."""
    import dataclasses

    from asr2pass_tpu_torch.config import sensevoice_tiny

    cfg = sensevoice_tiny(vocab)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, attention_heads=heads))


def weights(data, name: str) -> dict:
    import torch

    pre = f"w/{name}/"
    return {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(pre)}


def gather_whole(local, tensors=None) -> dict:
    """The whole state dict from each rank's shard (the inverse of
    sharding.shard_params), as numpy; with `tensors` ({key: tensor} of
    the shard's shapes, its gradients), those gathered the same way."""
    from asr2pass_tpu_torch.parallel import sharding

    sliced = sharding.sliced_params(local)
    if tensors is None:
        tensors = local.state_dict()
    out = {}
    for key, v in tensors.items():
        v = v.detach()
        if key in sliced:
            dim, group = sliced[key]
            v = sharding.gather_param(v, key, dim, group)
        out[key] = v.numpy().copy()
    return out


def _paraformer(sd, cfg):
    from asr2pass_tpu_torch.models import paraformer

    return paraformer.from_state_dict(sd, cfg, device="cpu")


def _forward_arrays(out, prefix: str) -> dict:
    res = {f"{prefix}logits": out.logits.numpy(),
           f"{prefix}token_num": out.token_num.numpy()}
    if out.us_alphas is not None:
        res[f"{prefix}us_alphas"] = out.us_alphas.numpy()
        res[f"{prefix}us_cif_peak"] = out.us_cif_peak.numpy()
    return res


def _lm_decoder(vocab):
    """A Python LM decoder over the test vocabulary's units: a bigram LM
    on sentences drawn from a seed."""
    from asr2pass_tpu_torch.decode.lm_decoder import Lexicon, LmDecoder
    from asr2pass_tpu_torch.decode.ngram import NgramLM

    rng = np.random.default_rng(11)
    units = vocab.tokens[4:]
    words = sorted({"".join(units[int(k)] for k in rng.integers(
        0, len(units), rng.integers(1, 3))) for _ in range(30)})
    sents = [[words[int(k)] for k in rng.integers(0, len(words),
                                                   rng.integers(2, 7))]
             for _ in range(40)]
    lex = Lexicon()
    for w in words:
        lex.add(w, list(w))
    return LmDecoder(NgramLM.train(sents, order=2), lex, lm_weight=0.8)


def case_paraformer_tp(data, spec, rank, world):
    """TP forwards (each case's mesh, every rank the whole batch) and the
    dp x tp recognizer, each beside the port's unsharded run; the
    collectives of one forward; tp 4 over 2 heads; int8 trees at tp 2;
    tp with sp; the refusals."""
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.parallel import comm, sharding
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.text.vocab import make_test_vocab
    from asr2pass_tpu_torch.utils import quantize_params

    res, js = {}, {}
    feats = torch.from_numpy(data["feats"])
    lengths = torch.from_numpy(data["lengths"]).long()
    hw = torch.from_numpy(data["hw_emb"])
    hw_mask = torch.from_numpy(data["hw_mask"])
    for c in spec["forwards"]:
        cfg = tp_cfg(c["heads"], c["timestamp"], c["hotword"])
        whole = _paraformer(weights(data, c["name"]), cfg)
        mesh = sharding.make_mesh(world, tp=c["tp"])
        local = sharding.shard_params(whole, mesh)
        kw = dict(max_tokens=feats.shape[1] // 2 + 8)
        if c["hotword"]:
            kw.update(hw_emb=hw, hw_mask=hw_mask)
        with torch.inference_mode():
            comm.reset_collective_counts()
            out = paraformer.apply(local, cfg, feats, lengths, **kw)
            js[f"{c['name']}/collectives"] = comm.collective_counts()
            ref = paraformer.apply(whole, cfg, feats, lengths, **kw)
        res.update(_forward_arrays(out, f"{c['name']}/tp/"))
        res.update(_forward_arrays(ref, f"{c['name']}/whole/"))
        js[f"{c['name']}/qkv_shape"] = list(
            local.encoder.first.att.qkv.w.shape)

    # the dp x tp recognizer, plain, with hotwords and with an LM
    cfg = tp_cfg(2, timestamp=True, hotword=True)
    vocab = make_test_vocab(cfg.vocab_size)
    sd = weights(data, "rec")
    segs = [data[f"seg{i}"] for i in range(int(data["n_segs"]))]
    hw_embs = [None, data["hw_emb"][0, :3]] + [None] * (len(segs) - 2)
    lm = _lm_decoder(vocab)
    mesh = sharding.make_mesh(world, tp=2)
    recs = {"whole": ParaformerOffline(sd, cfg, vocab, device="cpu"),
            "tp": ParaformerOffline(sd, cfg, vocab, device="cpu",
                                    tp_mesh=mesh)}
    for name, rec in recs.items():
        js[f"rec/{name}"] = rec.recognize_batch(segs)
        js[f"rec/{name}/hotword"] = rec.recognize_batch(segs,
                                                        hw_embs=hw_embs)
        js[f"rec/{name}/lm"] = rec.recognize_batch(
            segs, lm_decoders=[lm] * len(segs))

    # tp 4 over 2 heads: the attention modules whole, the FFNs and the
    # vocab head sliced; the forward and the dp 1 x tp 4 recognizer
    mesh4 = sharding.make_mesh(world, tp=4)
    heads_cfg = tp_cfg(2, True, True)
    whole = _paraformer(weights(data, "tp2"), heads_cfg)
    local = sharding.shard_params(whole, mesh4)
    with torch.inference_mode():
        comm.reset_collective_counts()
        out = paraformer.apply(local, heads_cfg, feats, lengths, hw_emb=hw,
                               hw_mask=hw_mask,
                               max_tokens=feats.shape[1] // 2 + 8)
        js["heads/collectives"] = comm.collective_counts()
    res.update(_forward_arrays(out, "heads/tp/"))
    js["heads/shapes"] = {
        "qkv": list(local.encoder.first.att.qkv.w.shape),
        "w1": list(local.encoder.first.ffn.w1.w.shape),
        "vocab": list(local.decoder.out.w.shape)}
    js["heads/whole_units"] = sorted(sharding.whole_units(whole, 4))
    js["rec/heads"] = ParaformerOffline(sd, cfg, vocab, device="cpu",
                                        tp_mesh=mesh4).recognize_batch(segs)

    # an int8 tree at dp 2 x tp 2: every unit whole
    int8_cfg = tp_cfg(4)
    for form, weight_only in (("w8a16", True), ("w8a8", False)):
        q = quantize_params(_paraformer(weights(data, "tp4"), int8_cfg),
                            weight_only=weight_only)
        local = sharding.shard_params(q, mesh)
        js[f"int8/{form}/sliced"] = len(sharding.sliced_params(local))
        with torch.inference_mode():
            for name, model in (("tp", local), ("whole", q)):
                res.update(_forward_arrays(paraformer.apply(
                    model, int8_cfg, feats, lengths,
                    max_tokens=feats.shape[1] // 2 + 8),
                    f"int8/{form}/{name}/"))
        js[f"rec/int8/{form}"] = ParaformerOffline(
            q, int8_cfg, vocab, device="cpu",
            tp_mesh=mesh).recognize_batch(segs)

    # tp 2 with sp 2 (both over a 2 x 2 mesh's inner axis) and sp 4: a
    # short segment takes the TP path, a long one the SP path
    from torch.distributed.device_mesh import init_device_mesh

    sp_meshes = {2: init_device_mesh("cpu", (world // 2, 2),
                                     mesh_dim_names=("dp", "sp")),
                 4: init_device_mesh("cpu", (world,),
                                     mesh_dim_names=("sp",))}
    tpsp = [segs[0], data["long"]]
    js["rec/whole/tpsp"] = recs["whole"].recognize_batch(tpsp)
    for n, sp_mesh in sp_meshes.items():
        rec = ParaformerOffline(sd, cfg, vocab, device="cpu", tp_mesh=mesh,
                                sp_mesh=sp_mesh,
                                sp_threshold=spec["sp_threshold"])
        comm.reset_collective_counts()
        js[f"rec/tpsp{n}"] = rec.recognize_batch(tpsp)
        js[f"rec/tpsp{n}/collectives"] = comm.collective_counts()
        js[f"rec/tpsp{n}/hotword"] = rec.recognize_batch(
            tpsp, hw_embs=[data["hw_emb"][0, :3], None])

    # refusals: a vocab tp does not divide, quantizing a shard
    refusals = {}
    for label, make in [
            ("vocab", lambda: sharding.shard_params(paraformer.init(
                tp_cfg(4, vocab=66), torch.Generator().manual_seed(0),
                "cpu"), mesh4)),
            ("quantize_after", lambda: quantize_params(sharding.shard_params(
                _paraformer(weights(data, "tp4"), tp_cfg(4)), mesh)))]:
        try:
            make()
            refusals[label] = None
        except ValueError as e:
            refusals[label] = str(e)
    js["refusals"] = refusals
    return res, js


def case_sensevoice_tp(data, spec, rank, world):
    """SenseVoice sharded at tp 2 and 4 (vocab 64): the rank's logits and
    the gathered ones, greedy ids, the sharded prune (with and without
    an id set) beside the whole prune, the collectives of each, and the
    recognizers' texts and meta: beam-only, and greedy and beam items
    with per-item contexts in one batch."""
    import torch

    from asr2pass_tpu_torch.decode.context_graph import ContextGraph
    from asr2pass_tpu_torch.models import sensevoice
    from asr2pass_tpu_torch.parallel import comm, sharding
    from asr2pass_tpu_torch.parallel.ctc_shard import (
        ctc_first_prune, ctc_first_prune_gather, ctc_first_prune_sharded,
        ctc_first_prune_sharded_gather)
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.text.vocab import make_test_vocab

    res, js = {}, {}
    feats = torch.from_numpy(data["feats"])
    args = [torch.from_numpy(data[k]).long()
            for k in ("lengths", "lid", "tn")]
    waves = [data[f"mixed{i}"] for i in range(int(data["n_mixed"]))]
    for tp in spec["tps"]:
        cfg = svs_cfg(tp)
        whole = sensevoice.from_state_dict(weights(data, f"svs{tp}"), cfg,
                                           "cpu")
        mesh = sharding.make_mesh(world, tp=tp)
        local = sharding.shard_params(whole, mesh)
        with torch.inference_mode():
            comm.reset_collective_counts()
            out = sensevoice.apply(local, cfg, feats, *args)
            js[f"svs{tp}/forward_collectives"] = comm.collective_counts()
            comm.reset_collective_counts()
            ids, counts, meta = sensevoice.greedy_ids(out)
            js[f"svs{tp}/greedy_collectives"] = comm.collective_counts()
            comm.reset_collective_counts()
            cid, clp = ctc_first_prune_sharded(out.logits, mesh, "tp",
                                               k=spec["k"])
            js[f"svs{tp}/prune_collectives"] = comm.collective_counts()
            comm.reset_collective_counts()
            gid, glp, ghw = ctc_first_prune_sharded_gather(
                out.logits, spec["hw_ids"], mesh, "tp", k=spec["k"])
            js[f"svs{tp}/prune_gather_collectives"] = \
                comm.collective_counts()
            ref = sensevoice.apply(whole, cfg, feats, *args).logits
            wid, wlp = ctc_first_prune(ref, k=spec["k"])
            _, _, whw = ctc_first_prune_gather(ref, spec["hw_ids"],
                                               k=spec["k"])
            logits = sensevoice.whole_logits(out)
        res.update({f"svs{tp}/logits": logits.numpy(),
                    f"svs{tp}/shard_logits": out.logits.numpy(),
                    f"svs{tp}/ids": ids.numpy(),
                    f"svs{tp}/counts": counts.numpy(),
                    f"svs{tp}/meta": meta.numpy(),
                    f"svs{tp}/prune_ids": cid.numpy(),
                    f"svs{tp}/prune_logp": clp.numpy(),
                    f"svs{tp}/gather_ids": gid.numpy(),
                    f"svs{tp}/gather_logp": glp.numpy(),
                    f"svs{tp}/gather_hw": ghw.numpy(),
                    f"svs{tp}/whole_prune_ids": wid.numpy(),
                    f"svs{tp}/whole_prune_logp": wlp.numpy(),
                    f"svs{tp}/whole_hw": whw.numpy()})
        vocab = make_test_vocab(cfg.vocab_size)
        rec = SenseVoiceOffline(whole, cfg, vocab, lang="zh", beam=4,
                                device="cpu", tp_mesh=mesh)
        comm.reset_collective_counts()
        js[f"svs{tp}/beam"] = rec.recognize_batch([data["wave"]],
                                                  with_meta=True)
        js[f"svs{tp}/beam_collectives"] = comm.collective_counts()
        for beam in (0, 4):
            rec = SenseVoiceOffline(whole, cfg, vocab, lang="zh", beam=beam,
                                    device="cpu", tp_mesh=mesh)
            ctx = [ContextGraph().build(spec["hot"]) if c else None
                   for c in spec["contexts"]]
            js[f"svs{tp}/mixed{beam}"] = rec.recognize_batch(
                waves, with_meta=True, contexts=ctx, langs=spec["langs"])
    return res, js


def case_sequence(data, spec, rank, world):
    """The SP encoder at sp 2 (a 2 x 2 mesh) and sp 4, whole and padded,
    beside the port's unsharded encoder; the SP recognizer's text."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from asr2pass_tpu_torch.config import EncoderConfig, paraformer_tiny
    from asr2pass_tpu_torch.models import sanm_encoder
    from asr2pass_tpu_torch.models.layers import length_mask
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.parallel.sequence import encode_sequence_parallel
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.text.vocab import make_test_vocab

    res, js = {}, {}
    meshes = {2: init_device_mesh("cpu", (world // 2, 2),
                                  mesh_dim_names=("dp", "sp")),
              4: init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))}
    for c in spec["encoders"]:
        cfg = EncoderConfig(input_size=560, output_size=32,
                            num_blocks=c["blocks"], attention_heads=2,
                            linear_units=64)
        enc = sanm_encoder.SanmEncoder(cfg, device="meta")
        enc.load_state_dict(weights(data, c["name"]), assign=True)
        feats = torch.from_numpy(data[f"{c['name']}/feats"])
        valid = c.get("valid")
        lengths = None if valid is None else [valid] * feats.shape[0]
        with torch.no_grad():
            mask = (None if valid is None else
                    length_mask(torch.tensor(lengths), feats.shape[1]))
            res[f"{c['name']}/whole"] = sanm_encoder.apply(
                enc, feats, mask, d_model=32, heads=2).numpy()
            for n, mesh in meshes.items():
                comm.reset_collective_counts()
                res[f"{c['name']}/sp{n}"] = encode_sequence_parallel(
                    enc, feats, cfg, mesh, axis="sp",
                    lengths=lengths).numpy()
                js[f"{c['name']}/sp{n}/collectives"] = \
                    comm.collective_counts()

    cfg = paraformer_tiny()
    vocab = make_test_vocab(cfg.vocab_size)
    sd = weights(data, "tiny")
    wave = data["wave"]
    js["rec/whole"] = ParaformerOffline(sd, cfg, vocab,
                                        device="cpu").recognize(wave)
    for n, mesh in meshes.items():
        js[f"rec/sp{n}"] = ParaformerOffline(
            sd, cfg, vocab, device="cpu", sp_mesh=mesh,
            sp_threshold=64).recognize(wave)
    return res, js


def case_train(data, spec, rank, world):
    """make_sharded_train_step at dp x tp = (world/tp) x tp, `steps` steps
    with each optimizer (make_optimizer's AdamW, and plain SGD at
    spec["sgd_lr"]), beside train_step on the whole batch; the whole
    params and gradients after each step. Then one step at tp = world
    over the model's 2 heads: its loss and gradient norms."""
    import dataclasses

    import torch

    from asr2pass_tpu_torch.parallel import sharding
    from asr2pass_tpu_torch.train import train

    cfg = tp_cfg(spec["tp"])
    cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor, threshold=spec["threshold"]))
    batch = train.TrainBatch(
        torch.from_numpy(data["feats"]),
        torch.from_numpy(data["feat_lens"]).long(),
        torch.from_numpy(data["targets"]).long(),
        torch.from_numpy(data["target_lens"]).long())
    mesh = sharding.make_mesh(world, tp=spec["tp"])
    step = train.make_sharded_train_step(cfg, mesh)

    def optimizer(model, kind):
        adamw = train.make_optimizer(model)
        if kind == "adamw":
            return adamw
        return torch.optim.SGD(adamw.param_groups[0]["params"],
                               lr=spec["sgd_lr"])

    res, js = {}, {}
    for kind in ("adamw", "sgd"):
        whole = _paraformer(weights(data, "model"), cfg)
        local = sharding.shard_params(whole, mesh)
        opt, ref_opt = optimizer(local, kind), optimizer(whole, kind)
        js[kind] = {"loss": [], "whole_loss": [], "metrics": []}
        for i in range(spec["steps"]):
            m = step(local, opt, batch)
            js[kind]["loss"].append(float(m["loss"]))
            js[kind]["metrics"].append({k: float(v) for k, v in m.items()})
            js[kind]["whole_loss"].append(float(train.train_step(
                whole, ref_opt, batch, cfg)["loss"]))
            for k, v in gather_whole(local).items():
                res[f"{kind}/step{i}/sharded/{k}"] = v
            grads = {k: p.grad for k, p in whole.named_parameters()}
            for k, v in whole.state_dict().items():
                res[f"{kind}/step{i}/whole/{k}"] = v.detach().numpy().copy()
                g = grads.get(k)
                res[f"{kind}/step{i}/grad/{k}"] = (
                    np.zeros(v.shape, np.float32) if g is None
                    else g.numpy().copy())

    # tp 4 over the model's 2 heads (dp 1): the attention modules whole;
    # one AdamW step's loss and gradient norms beside train_step's
    mesh4 = sharding.make_mesh(world, tp=4)
    whole = _paraformer(weights(data, "model"), cfg)
    local = sharding.shard_params(whole, mesh4)
    js["heads/whole_units"] = len(sharding.whole_units(whole, 4))
    m = train.make_sharded_train_step(cfg, mesh4)(
        local, train.make_optimizer(local), batch)
    js["heads/loss"] = float(m["loss"])
    js["heads/whole_loss"] = float(train.train_step(
        whole, train.make_optimizer(whole), batch, cfg)["loss"])
    grads = gather_whole(local, {k: p.grad for k, p in
                                 local.named_parameters()})
    js["heads/grad_norms"] = {k: float(np.linalg.norm(g))
                              for k, g in grads.items()}
    js["heads/whole_grad_norms"] = {
        k: float(p.grad.norm()) for k, p in whole.named_parameters()}
    return res, js


def case_multihost(data, spec, rank, world):
    """init_distributed from the environment (done in main),
    local_batch_slice and make_global_mesh."""
    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.multihost import (local_batch_slice,
                                                       make_global_mesh)

    mesh = make_global_mesh(tp=2)
    sl = local_batch_slice(spec["global_batch"])
    return {}, {"world": dist.get_world_size(), "rank": dist.get_rank(),
                "backend": dist.get_backend(),
                "slice": [sl.start, sl.stop],
                "mesh": list(mesh.shape),
                "names": list(mesh.mesh_dim_names),
                "tp_rank": mesh.get_local_rank("tp")}


# ---------------------------------------------------------------------------
# serving on several ranks (server/fanout.py)
# ---------------------------------------------------------------------------

MESSAGE = 9600           # samples a client message carries: 600 ms


def session_results(sess, wave) -> dict:
    """A session fed 600 ms messages: its concatenated partials and its
    finals with their timestamps."""
    partial, finals = "", []
    for off in range(0, len(wave), MESSAGE):
        res = sess.feed(wave[off: off + MESSAGE],
                        off + MESSAGE >= len(wave))
        partial += res.partial or ""
        if res.final_text:
            finals.append([res.final_text, _stamps(res.timestamps)])
    return {"partial": partial, "finals": finals}


def _stamps(ts):
    return [[int(a) for a in p] for p in ts] if ts else []


def engine_results(eng, waves, opens=None) -> list:
    """Streams through a StreamEngine (either package's) in 600 ms
    messages, one a stream a tick, then ticks until every stream is
    drained; per stream its concatenated partials and [final text,
    timestamps]."""
    sids = [eng.open(**(opens[i] if opens else {}))
            for i in range(len(waves))]
    out = {sid: [] for sid in sids}
    for off in range(0, max(len(w) for w in waves), MESSAGE):
        for sid, w in zip(sids, waves):
            if off < len(w):
                eng.feed(sid, w[off: off + MESSAGE],
                         is_final=off + MESSAGE >= len(w))
        eng.step()
        for sid in sids:
            out[sid] += eng.poll(sid)
    deadline = time.time() + 120
    while time.time() < deadline and not (
            all(eng.drained(s) for s in sids) and not eng.has_inflight()):
        eng.step()
        for sid in sids:
            out[sid] += eng.poll(sid)
        time.sleep(0.005)
    for sid in sids:
        out[sid] += eng.poll(sid)
        assert eng.drained(sid)
    eng.shutdown()
    return [{"partial": "".join(r["text"] for r in out[s]
                                if r["mode"] == "2pass-online"),
             "finals": [[r["text"], _stamps(r.get("timestamp"))]
                        for r in out[s] if r["mode"] == "2pass-offline"]}
            for s in sids]


def upload_result(rec, wave) -> list:
    res = rec.transcribe(wave)
    return [res.text, _stamps(res.timestamps)]


def _server_models(spec, name: str, extra=()):
    """ServerModels from saved dirs through the launcher's build_models,
    on the CPU, over the group's ranks with --tp-devices or
    --sp-devices in `extra`."""
    from asr2pass_tpu_torch.server.run_server import build_models, parser

    return build_models(parser().parse_args(
        spec["argv"][name] + ["--device", "cpu", *extra]))


def _serve_rank0(models, work) -> dict:
    """Rank 0's side of one server config: run `work(models)`, stop the
    workers, add this rank's collectives and fan-out numbers."""
    from asr2pass_tpu_torch.parallel import comm

    comm.reset_collective_counts()
    js = work(models)
    models.fanout.stop()
    js["collectives"] = comm.collective_counts()
    js["fanout"] = models.fanout.stats()
    return js


def _serve_worker(models) -> dict:
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.server.fanout import serve_worker

    comm.reset_collective_counts()
    serve_worker(models)
    return {"collectives": comm.collective_counts()}


def _hotword_work(data, spec):
    """The Paraformer server's requests: an upload, a 2pass session, a
    hotworded session, an engine of two streams (one hotworded), two
    uploads from two threads at once, then the shards held."""
    import threading

    def work(models):
        js = {}
        waves = [data[f"wave{i}"] for i in range(3)]
        hot = spec["hotwords"]
        js["upload"] = upload_result(models.create_offline_recognizer(),
                                     waves[0])
        sessions = [models.create_session(), models.create_session(
            hw_emb=models.compile_hotwords(hot), hotwords=hot)]
        js["session"] = session_results(sessions[0], waves[1])
        js["hotword"] = session_results(sessions[1], waves[1])
        from asr2pass_tpu_torch.runtime.engine import StreamEngine

        eng = StreamEngine(models, capacity=4, fused_fetch=True,
                           pass2_async=True)
        eng.warmup()
        eng.warm_pass2_ring()
        js["engine"] = engine_results(eng, waves[:2], [
            {}, dict(hw_emb=models.compile_hotwords(hot), hotwords=hot)])
        # two rank-0 threads at once: the fan-out's lock orders them
        recs = [models.create_offline_recognizer(vad_tail_sil=800 + k)
                for k in range(2)]
        got = [None, None]

        def upload(k):
            got[k] = upload_result(recs[k], waves[2 - k])

        threads = [threading.Thread(target=upload, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        js["threads"] = got
        js["serial"] = [upload_result(recs[k], waves[2 - k])
                        for k in range(2)]
        shard = models._tp_shard_cache["asr"]
        js["shards"] = sorted(models._tp_shard_cache)
        js["shared"] = all(
            r.model is shard for r in
            [s.offline_asr for s in sessions] + [eng.offline.asr]
            + [r.asr for r in recs])
        js["lock_waits"] = len(models.fanout.lock_wait_s)
        return js

    return work


def _svs_work(data, spec):
    """The SenseVoice server's requests: a session with a hotword context
    and svs_lang, an upload."""
    def work(models):
        wave = data["wave1"]
        sess = models.create_session(use_svs=True, svs_lang="zh",
                                     hotwords=spec["svs_hotwords"])
        return {"context": session_results(sess, wave),
                "upload": upload_result(models.create_offline_recognizer(
                    use_svs=True, svs_lang="en"), data["wave0"]),
                "shards": sorted(models._tp_shard_cache)}

    return work


def _tlg_work(data, spec):
    """The SenseVoice server with a CTC TLG graph: a session."""
    def work(models):
        sess = models.create_session(use_svs=True)
        return {"tlg": session_results(sess, data["wave1"])}

    return work


def case_serving_tp(data, spec, rank, world):
    """Servers at tp `world` through the launcher's build_models: rank 0
    serves the requests of _hotword_work, _svs_work and _tlg_work through
    the fan-out, the others run serve_worker; each rank reports its
    collectives."""
    js = {}
    extra = ["--tp-devices", str(world)]
    for name, work in (("hotword", _hotword_work(data, spec)),
                       ("svs", _svs_work(data, spec)),
                       ("tlg", _tlg_work(data, spec))):
        models = _server_models(spec, name, extra)
        js[name] = (_serve_rank0(models, work) if rank == 0
                    else _serve_worker(models))
    return {}, js


def case_serving_sp(data, spec, rank, world):
    """An --sp-devices server with a small --sp-threshold: an upload past
    it (fanned out) and one below it (rank 0 alone)."""
    extra = ["--sp-devices", str(world), "--sp-threshold",
             str(spec["sp_threshold"])]
    models = _server_models(spec, "asr", extra)
    if rank > 0:
        return {}, _serve_worker(models)

    def work(models):
        rec = models.create_offline_recognizer(vad_max_len=spec["max_len"])
        long = upload_result(rec, data["long"])
        calls = models.fanout.calls
        short = upload_result(rec, data["wave2"])
        return {"long": long, "short": short, "calls_long": calls,
                "calls_short": models.fanout.calls - calls}

    return {}, _serve_rank0(models, work)


def case_serving_tpsp(data, spec, rank, world):
    """A server with --tp-devices and --sp-devices together: an upload
    past --sp-threshold, one below it, and an engine whose lane takes a
    segment past it (the call carries its samples beside the broadcast
    ring features) and a short one."""
    extra = ["--tp-devices", str(spec["tp"]), "--sp-devices",
             str(spec["sp"]), "--sp-threshold", str(spec["sp_threshold"])]
    models = _server_models(spec, "asr", extra)
    if rank > 0:
        return {}, _serve_worker(models)

    def work(models):
        from asr2pass_tpu_torch.runtime.engine import StreamEngine

        rec = models.create_offline_recognizer(vad_max_len=spec["max_len"])
        js = {"long": upload_result(rec, data["long"]),
              "short": upload_result(rec, data["wave2"]),
              "meshes": [list(models.tp_mesh.mesh.shape),
                         list(models.sp_mesh.mesh.shape)]}
        eng = StreamEngine(models, capacity=2, fused_fetch=True,
                           pass2_async=True)
        eng.warmup()
        eng.warm_pass2_ring()
        js["engine"] = engine_results(eng, [data["long"], data["wave2"]])
        return js

    return {}, _serve_rank0(models, work)


def case_serving_dp(data, spec, rank, world):
    """Serving dp: every process its own StreamEngine on its own audio in
    one gloo group; a fresh engine on the same audio in the same process
    gives the same results."""
    from asr2pass_tpu_torch.runtime.engine import StreamEngine

    models = _server_models(spec, "asr")
    wave = data[f"wave{rank}"]
    got = engine_results(StreamEngine(models, capacity=2), [wave])[0]
    fresh = engine_results(StreamEngine(models, capacity=2), [wave])[0]
    return {}, {"engine": got, "fresh": fresh}


def case_serving_fault(data, spec, rank, world):
    """A rank-0 failure after a call went out: rank 0's forward raises
    once the header is sent; both ranks must exit non-zero."""
    models = _server_models(spec, "asr", ["--tp-devices", str(world)])
    if rank > 0:
        return {}, _serve_worker(models)
    rec = models.create_offline_recognizer()
    try:
        rec.asr.dispatch_batch([data["wave0"][:1000]], hw_embs=[
            np.zeros((2, 3, 4), np.float32)])
    except ValueError as e:
        print(f"refused before sending: {e}", flush=True)
    calls = models.fanout.calls

    def boom(*a, **k):
        raise RuntimeError("injected failure after the send")

    rec.asr._forward = boom
    print(f"calls before the fault: {calls}", flush=True)
    rec.transcribe(data["wave0"])
    return {}, {"unreachable": True}


CASES = {"paraformer_tp": case_paraformer_tp,
         "sensevoice_tp": case_sensevoice_tp,
         "sequence": case_sequence, "train": case_train,
         "multihost": case_multihost, "serving_tp": case_serving_tp,
         "serving_sp": case_serving_sp, "serving_tpsp": case_serving_tpsp,
         "serving_dp": case_serving_dp,
         "serving_fault": case_serving_fault}


def main():
    case, d, rank, world = sys.argv[1], Path(sys.argv[2]), \
        int(sys.argv[3]), int(sys.argv[4])
    import torch

    torch.set_num_threads(1)
    from asr2pass_tpu_torch.parallel.multihost import init_distributed

    if case == "multihost":
        os.environ.update(COORDINATOR_ADDRESS=f"file://{d / 'rdv'}",
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        assert init_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    else:
        assert init_distributed(f"file://{d / 'rdv'}", world, rank,
                                device="cpu", timeout_s=GROUP_TIMEOUT_S)
    spec = json.loads((d / "spec.json").read_text())
    with np.load(d / "in.npz") as data:
        res, js = CASES[case](data, spec, rank, world)
    np.savez(d / f"out{rank}.npz", json=np.array(json.dumps(js)), **res)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
