"""Launch the websocket ASR server from model directories.

    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \\
        --online-model-dir DIR --vad-dir DIR --punc-dir DIR --engine
    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \
        --vad-dir DIR --punc-dir DIR --svs-dir DIR --engine
    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \
        --vad-dir DIR --lm-dir GRAPH_OR_ARPA_DIR --itn-dir FST_DIR --engine
    python -m asr2pass_tpu_torch.server.run_server --demo --device cpu

Counterpart of scripts/run_server.py (the role of
funasr-wss-server-2pass.cpp main), with the flags whose modules are
ported. The model directories are the ones both packages read and write
(runtime/model_zoo.py). A --model-dir whose weights carry a
`hotword_compiler` subtree (a converted hotword model) serves NN hotword
biasing: first-message hotwords compile into embeddings, with the dir's
seg_dict for English words when it has one. --svs-dir makes SenseVoice
pass 2. --lm-dir rescores pass 2 with an n-gram LM: a compiled graph
dir (TLG.fst, words.txt, tokens.txt; tools/build_tlg.py) when it holds
TLG.fst, else lm.arpa + lexicon.txt (tools/build_lm.py); SenseVoice takes
only a graph with the CTC topology (build_tlg --ctc-blank). --itn-dir (or
--itn-tagger with --itn-verbalizer) loads compiled WeTextProcessing ITN
grammars in place of the rule ITN. --demo builds random tiny models
(protocol and load testing without trained weights). The models run on
--device: cuda (the default), cuda:N, or cpu for the plain PyTorch path;
the LM, TLG and FST searches run in the native library on the host.

Several cards (the JAX launcher's --tp-devices, --sp-devices and
--sp-threshold, same meanings and defaults):

    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \
        --vad-dir DIR --punc-dir DIR --engine --tp-devices 2
    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \
        --vad-dir DIR --sp-devices 4 --sp-threshold 4096

The launcher is rank 0 of N: it starts ranks 1..N-1 as child processes
of this program with the same flags (a file:// rendezvous in a
temporary directory), each on the card of its rank (NCCL; gloo with
--device cpu), and every rank builds the same models. --tp-devices
shards the pass-2 model over a dp 1 x tp N mesh; --sp-devices runs
offline segments past --sp-threshold LFR frames sequence-parallel over
N. Rank 0 serves; the others replay its pass-2 calls
(server/fanout.serve_worker). A collective that does not complete
within --dist-timeout seconds ends the ranks, and rank 0 exits non-zero
when a worker ends: the fleet supervisor (server/run_all_servers.py)
restarts it. The two flags combine when the smaller count divides the
larger: the larger is the number of ranks, the TP mesh is (ranks / N)
dp x N tp with the rows over dp, and each group of M consecutive ranks
runs the SP encoder; segments up to --sp-threshold take TP, longer
ones SP:

    python -m asr2pass_tpu_torch.server.run_server --model-dir DIR \
        --vad-dir DIR --tp-devices 2 --sp-devices 4
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import ssl
import subprocess
import sys
import tempfile
import threading

log = logging.getLogger("asr2pass.server")
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m asr2pass_tpu_torch.server.run_server")
    p.add_argument("--model-dir", help="offline (pass-2) model directory")
    p.add_argument("--online-model-dir", help="streaming model directory")
    p.add_argument("--vad-dir", help="VAD model directory")
    p.add_argument("--punc-dir", help="punctuation model directory")
    p.add_argument("--svs-dir",
                   help="SenseVoice-small model dir (pass-2 alternative; "
                        "the reference's MODEL_SVS role). When set, 2pass "
                        "finals and offline uploads decode through "
                        "SenseVoice instead of the offline Paraformer")
    p.add_argument("--svs-beam", type=int, default=0,
                   help="SenseVoice CTC prefix-beam width (0/1 = greedy; "
                        "hotworded connections always get the context-"
                        "biased beam, sensevoice-small.cpp:392-440)")
    p.add_argument("--lm-dir",
                   help="n-gram LM dir: a compiled TLG graph (TLG.fst + "
                        "words.txt + tokens.txt, the reference's artifact "
                        "layout, tools/build_tlg.py) or lm.arpa + "
                        "lexicon.txt (tools/build_lm.py)")
    p.add_argument("--lm-weight", type=float, default=0.5)
    p.add_argument("--itn-dir",
                   help="ITN dir holding zh_itn_tagger.fst and "
                        "zh_itn_verbalizer.fst (the reference's "
                        "--itn-model-dir; shorthand for the two flags "
                        "below)")
    p.add_argument("--itn-tagger", help="compiled ITN tagger FST (the "
                                        "reference's zh_itn_tagger.fst)")
    p.add_argument("--itn-verbalizer",
                   help="compiled ITN verbalizer FST "
                        "(zh_itn_verbalizer.fst)")
    p.add_argument("--hotword-file", default="",
                   help="server-side hotwords, one 'word [score]' a line, "
                        "merged with each connection's")
    p.add_argument("--itn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="rule-based Chinese ITN on finals (default on, like "
                        "the reference's 2pass launch scripts)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10095)
    p.add_argument("--decode-workers", type=int, default=1)
    p.add_argument("--engine", action="store_true",
                   help="batched StreamEngine serving (one batched step "
                        "advances all connections)")
    p.add_argument("--engine-capacity", type=int, default=128)
    p.add_argument("--upload-overlap", action="store_true",
                   help="engine mode: stage and upload the next tick's "
                        "audio on a lane during the tick's fetch")
    p.add_argument("--decide-async", action="store_true",
                   help="engine mode: VAD automaton and splitter on the "
                        "decide lane")
    p.add_argument("--max-message-mb", type=int, default=16,
                   help="max websocket frame size (MB)")
    p.add_argument("--max-upload-mb", type=int, default=256,
                   help="max per-connection offline upload size (MB)")
    p.add_argument("--certfile", default="")
    p.add_argument("--keyfile", default="")
    p.add_argument("--demo", action="store_true",
                   help="random tiny models (protocol testing)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--tp-devices", type=int, default=0,
                   help="shard the pass-2 model Megatron-style over this "
                        "many cards, one process a card (tensor "
                        "parallelism; 0 = off)")
    p.add_argument("--sp-devices", type=int, default=0,
                   help="run offline segments longer than --sp-threshold "
                        "LFR frames time-sharded over this many cards "
                        "(sequence parallelism; 0 = off)")
    p.add_argument("--sp-threshold", type=int, default=4096,
                   help="LFR frames (60 ms each) above which segments "
                        "take the sequence-parallel path (default 4096: "
                        "the single-shot attention kernels cover T<=4096)")
    p.add_argument("--dist-timeout", type=float, default=120.0,
                   help="seconds a collective of the ranks may take "
                        "before the ranks exit (--tp-devices, "
                        "--sp-devices)")
    # set by the launcher for the ranks it starts
    p.add_argument("--dist-rank", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--dist-init", default="", help=argparse.SUPPRESS)
    return p


def parallel_world(args) -> int:
    """The ranks --tp-devices and --sp-devices ask for (0: one process):
    the larger count when both are given, which the smaller must divide.
    Raises SystemExit for another pair (the JAX launcher takes any pair:
    its meshes are the first N and the first M devices of one process),
    or for a device the ranks cannot take."""
    tp, sp = args.tp_devices, args.sp_devices
    if tp < 0 or sp < 0:
        raise SystemExit("--tp-devices/--sp-devices take a count >= 0")
    n = max(tp, sp)
    if tp and sp and n % min(tp, sp):
        raise SystemExit(f"--tp-devices {tp} with --sp-devices {sp}: the "
                         "ranks are the larger count, which the smaller "
                         "must divide")
    if n and args.device not in ("cuda", "cpu"):
        raise SystemExit(f"--device {args.device}: the ranks take a card "
                         "each by their rank; pass --device cuda (or cpu)")
    return n


def join_ranks(args, argv, world: int):
    """Every rank joins the group; rank 0 (the launcher) first starts
    ranks 1..world-1 as children running argv plus their rank. Returns
    (the children, the rendezvous directory) on rank 0, ([], None) on
    the others. On the card each rank takes the card of its rank, and
    args.device names it."""
    import torch

    from asr2pass_tpu_torch.parallel.multihost import (init_distributed,
                                                       start_local_ranks)
    from asr2pass_tpu_torch.utils import resolve_device

    resolve_device(args.device)   # no card for --device cuda: raise here
    children, rdv_dir = [], None
    if args.dist_rank == 0:
        rdv_dir = tempfile.mkdtemp(prefix="asr2pass_ranks_")
        args.dist_init = f"file://{rdv_dir}/rdv"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [PACKAGE_ROOT] + [x for x in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if x]))
        children = start_local_ranks(
            lambda r: [sys.executable, "-m",
                       "asr2pass_tpu_torch.server.run_server", *argv,
                       "--dist-rank", str(r), "--dist-init",
                       args.dist_init], world, env=env)
    init_distributed(args.dist_init, world, args.dist_rank,
                     device=args.device, timeout_s=args.dist_timeout)
    if args.device == "cuda":
        args.device = f"cuda:{torch.cuda.current_device()}"
    return children, rdv_dir


def mesh_options(args) -> dict:
    """ServerModels' mesh fields from --tp-devices N / --sp-devices M,
    over the joined group of parallel_world's ranks: a (ranks / N) dp x
    N tp mesh (dp 1 alone: the JAX launcher's make_mesh(n, tp=n)), and a
    (ranks / M) x M "sp" mesh with --sp-threshold, each group of M
    consecutive ranks running the sequence-parallel encoder on its own
    (with M the smaller count, the same work as the JAX launcher's sp
    mesh over M devices, every rank holding the result)."""
    import torch.distributed as dist

    opts = {}
    if args.tp_devices:
        from asr2pass_tpu_torch.parallel.sharding import make_mesh

        opts["tp_mesh"] = make_mesh(tp=args.tp_devices)
    if args.sp_devices:
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        opts.update(sp_mesh=init_device_mesh(
            "cuda" if args.device.startswith("cuda") else "cpu",
            (world // args.sp_devices, args.sp_devices),
            mesh_dim_names=("dp", "sp")), sp_threshold=args.sp_threshold)
    return opts


def build_models(args):
    """ServerModels from the parsed flags (model directories, or the demo
    models), on args.device."""
    from asr2pass_tpu_torch.server.engine import ServerModels

    opts = dict(lm_options(args), **mesh_options(args))
    if args.demo:
        import torch

        from asr2pass_tpu_torch.config import (VadConfig, paraformer_tiny,
                                               punc_tiny)
        from asr2pass_tpu_torch.models import (ct_transformer, fsmn_vad,
                                               paraformer)
        from asr2pass_tpu_torch.text.punc_tokenizer import PuncTokenizer
        from asr2pass_tpu_torch.text.vocab import make_test_vocab

        gen = torch.Generator().manual_seed(0)
        acfg, vcfg, pcfg = paraformer_tiny(), VadConfig(), punc_tiny(300)
        models = ServerModels(
            asr_params=paraformer.init(acfg, gen, "cpu"), asr_cfg=acfg,
            vocab=make_test_vocab(acfg.vocab_size),
            vad_params=fsmn_vad.init(vcfg, gen, "cpu"), vad_cfg=vcfg,
            punc_params=ct_transformer.init(pcfg, gen, "cpu"),
            punc_cfg=pcfg,
            punc_tokenizer=PuncTokenizer(
                ["<blank>", "<unk>"]
                + [chr(0x4E00 + i) for i in range(200)]),
            device=args.device, **opts)
    else:
        from asr2pass_tpu_torch.runtime import model_zoo

        if not args.model_dir:
            raise SystemExit("--model-dir required (or --demo)")
        b = model_zoo.load_offline_bundle(args.model_dir)
        kw = {}
        if args.online_model_dir:
            ob = model_zoo.load_offline_bundle(args.online_model_dir)
            kw.update(online_params=ob.params, online_cfg=ob.cfg)
        if args.vad_dir:
            vad_sd, vad_cfg, vad_cmvn = model_zoo.load_vad_dir(args.vad_dir)
            kw.update(vad_params=vad_sd, vad_cfg=vad_cfg,
                      vad_cmvn=vad_cmvn)
        if args.punc_dir:
            punc_sd, punc_cfg, punc_tok = model_zoo.load_punc_dir(
                args.punc_dir)
            kw.update(punc_params=punc_sd, punc_cfg=punc_cfg,
                      punc_tokenizer=punc_tok)
        if b.hotword_params is not None:
            # a converted hotword model: its compiler rides in the ASR
            # weights (the JAX converter writes bias_encoder/bias_embed
            # as hotword_compiler), with the dir's seg_dict for English
            # BPE pieces (the reference loads both from the hotword model
            # dir, funasr-wss-server-2pass.cpp:195-502)
            from asr2pass_tpu_torch.config import HotwordConfig
            from asr2pass_tpu_torch.models.hotword import SegDict

            kw.update(hotword_params=b.hotword_params,
                      hotword_cfg=HotwordConfig())
            sd_path = os.path.join(args.model_dir, "seg_dict")
            if os.path.exists(sd_path):
                kw["seg_dict"] = SegDict(sd_path)
        if args.svs_dir:
            sb = model_zoo.load_svs_bundle(args.svs_dir)
            kw.update(svs_params=sb.params, svs_cfg=sb.cfg,
                      svs_vocab=sb.vocab, svs_cmvn=sb.cmvn)
        models = ServerModels(
            asr_params=b.params, asr_cfg=b.cfg, vocab=b.vocab,
            asr_cmvn=b.cmvn, svs_beam=args.svs_beam,
            device=args.device, **kw, **opts)
    tagger, verbalizer = args.itn_tagger, args.itn_verbalizer
    if args.itn_dir:
        tagger = tagger or os.path.join(args.itn_dir, "zh_itn_tagger.fst")
        verbalizer = verbalizer or os.path.join(args.itn_dir,
                                                "zh_itn_verbalizer.fst")
    if tagger or verbalizer:
        if not (tagger and verbalizer):
            raise SystemExit("--itn-tagger and --itn-verbalizer go "
                             "together (or --itn-dir)")
        from asr2pass_tpu_torch.text.itn import FstITN

        models.itn = FstITN(tagger, verbalizer)
    elif args.itn:
        from asr2pass_tpu_torch.text.itn import ChineseITN

        models.itn = ChineseITN()
    if args.hotword_file and os.path.exists(args.hotword_file):
        models.server_hotwords = read_hotword_file(args.hotword_file)
    return models


def lm_options(args) -> dict:
    """ServerModels' LM fields from --lm-dir and --lm-weight: tlg_dir
    for a dir with TLG.fst, else lm and lexicon from its lm.arpa and
    lexicon.txt."""
    if not args.lm_dir:
        return {}
    if os.path.exists(os.path.join(args.lm_dir, "TLG.fst")):
        return {"tlg_dir": args.lm_dir, "lm_weight": args.lm_weight}
    from asr2pass_tpu_torch.decode.lm_decoder import Lexicon
    from asr2pass_tpu_torch.decode.ngram import NgramLM

    return {"lm": NgramLM.load_arpa(os.path.join(args.lm_dir, "lm.arpa")),
            "lexicon": Lexicon.from_file(
                os.path.join(args.lm_dir, "lexicon.txt")),
            "lm_weight": args.lm_weight}


def read_hotword_file(path: str) -> dict:
    """Server-side hotwords (ExtractHws role, util.cpp:1001-1096): one
    hotword a line, its score last when the line has one (default 20)."""
    hws = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= 2:
                try:
                    hws[" ".join(parts[:-1])] = int(parts[-1])
                    continue
                except ValueError:
                    pass
            if parts and parts[0]:
                hws[parts[0]] = 20
    return hws


def watch_ranks(children, stopping: threading.Event) -> None:
    """Rank 0 exits (non-zero) when one of its workers ends before the
    server stops: the group cannot serve without it."""
    def wait(rank, proc):
        rc = proc.wait()
        if stopping.is_set():
            return
        log.critical("rank %d exited with %s; the server exits", rank, rc)
        for other in children:
            if other.poll() is None:
                other.kill()
        for h in logging.getLogger().handlers:
            h.flush()
        os._exit(1)

    for rank, proc in enumerate(children, 1):
        threading.Thread(target=wait, args=(rank, proc), daemon=True,
                         name=f"watch-rank{rank}").start()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    world = parallel_world(args)
    children, rdv_dir = [], None
    stopping = threading.Event()
    stopped = False
    if args.dist_rank == 0:
        # SIGTERM (the supervisor's) stops the server like ^C: its
        # shutdown stops the worker ranks
        signal.signal(signal.SIGTERM, _interrupt)
    try:
        if world:
            children, rdv_dir = join_ranks(args, argv, world)
            watch_ranks(children, stopping)
        models = build_models(args)
        if args.dist_rank > 0:
            from asr2pass_tpu_torch.server.fanout import serve_worker

            serve_worker(models)
            if models.device.type == "cuda":
                import json

                from asr2pass_tpu_torch.ops import attention as att

                log.info("rank %d: attention launches %s", args.dist_rank,
                         json.dumps(att.launch_counts_by_dtype()))
            stopped = True
            return
        ssl_ctx = None
        if args.certfile:
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(args.certfile, args.keyfile or None)

        from asr2pass_tpu_torch.server.ws_server import AsrWsServer

        try:
            AsrWsServer(models, host=args.host, port=args.port,
                        decode_workers=args.decode_workers,
                        ssl_context=ssl_ctx, use_engine=args.engine,
                        engine_capacity=args.engine_capacity,
                        upload_overlap=args.upload_overlap,
                        decide_async=args.decide_async,
                        max_message_bytes=args.max_message_mb << 20,
                        max_upload_bytes=args.max_upload_mb << 20
                        ).run_forever()
        except KeyboardInterrupt:
            log.info("stopped")
        stopped = True
    finally:
        stopping.set()
        if world and stopped:
            end_group(args.dist_timeout)
        for proc in children:
            # after a stop the workers leave serve_worker and end the group
            # with rank 0; after a failure they may wait in a collective:
            # end them
            try:
                proc.wait(timeout=args.dist_timeout if stopped else 0.1)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if rdv_dir is not None:
            shutil.rmtree(rdv_dir, ignore_errors=True)


def end_group(timeout_s: float) -> None:
    """destroy_process_group on every rank at once (NCCL's finalize waits
    for all of them, so rank 0 must not wait for its workers' exit
    first), given at most timeout_s."""
    import torch.distributed as dist

    if dist.is_initialized():
        t = threading.Thread(target=dist.destroy_process_group,
                             daemon=True, name="end-group")
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            log.warning("the process group did not end within %.0f s",
                        timeout_s)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


if __name__ == "__main__":
    main()
