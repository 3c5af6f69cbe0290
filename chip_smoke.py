#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr2pass_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which fails the run if it fails:
  1. build    compile the attention kernels from asr2pass_tpu_torch/csrc
              with nvcc (at first use, into asr2pass_tpu_torch/_build):
              csrc/attention_f32_sm90.cu (fp32, 3xTF32 wgmma: a K/V
              pre-pass, the main kernel fed by bulk copies, a combine of
              key splits) and csrc/attention_sm90.cu (bf16, wgmma + TMA),
              both including csrc/tma.cuh; print each instantiation's
              registers, spills and shared memory, and ptxas's wgmma
              warnings. Beside them, g++ builds the native host
              library from asr2pass_tpu_torch/native/src (the resampler,
              the VAD automaton, the CTC prefix beam); its seconds are
              printed. Then the native resampler against its numpy
              version on 60 s at 44.1 -> 16 kHz and 8 -> 16 kHz: lengths
              within 1, interior within 2e-4; ms of each
  2. kernels  hold each kernel entry point against its plain PyTorch version
              on the card at main-path shapes, fp32 and bf16, each with a
              length-0 row, a dropped-key control that the tolerance must
              reject and, in fp32, a TF32 control (q, k, v and P cut to
              TF32, one product each) that it must reject too; time
              kernel, plain version and (as a yardstick only) torch's
              scaled_dot_product_attention on the same work, each as
              back-to-back calls (ms), on the device alone (device_ms) and
              on the host's clock (host_ms); print which kernel SDPA runs
              in fp32. Each fp32 case prints its schedule (f32_schedule's
              key splits and grid) and its device ms split into pre-pass,
              main kernel and combine; the engine lane's shape (B=16,
              T=256) is a case, and one case runs each schedule the
              planner picks past the main path's (16 key splits; head
              dims 32, 64, 256), with the same gates
  3. main     build paraformer_large (timestamp head) from a seeded
              generator, save it as a model dir, load it with
              load_offline_bundle and answer three OfflineRecognizer.
              transcribe requests (60 s, 150 s, 270 s of seeded synthetic
              audio); launch counters must show every kernel ran there
  4. cpu      one 15 s segment, front-end and forward, on the card and on
              the CPU (plain versions), same weights: features and logits
              within tolerance, equal token_num; the same run with TF32
              products on must fail both limits (a negative control)
  5. speed    recognize_batch on 16 x 60 s segments (fp32) and the bench.py
              forward shape in bf16 (B=16, T=1000), as audio-s/s; the bf16
              forward must launch the bf16 kernel 66 times, and two bf16
              forwards at B=2, T=3072 and 5120, the split-head entry
              points 50 times each
  6. profile  one traced run of each: device busy time, idle share, and
              the kernels that took the most device time
  7. 2pass    the 2pass session at full width: paraformer_large_online
              (pass 1), the phase-3 paraformer_large dir (pass 2),
              vad_default (FSMN-VAD) and PuncConfig() (CT-Transformer),
              each saved as a model dir and loaded back, take ~59 s of
              seeded audio (four speech-like bursts between stretches of
              digital silence) in 600 ms messages. Gates: one closed VAD
              segment per burst starting within 300 ms of it, one
              non-empty punctuated final per segment with its timestamps
              inside it, non-empty partials, finite outputs, the fp32
              kernel launched 50 times per bucket-256 segment and nothing
              else; card vs CPU: the same VAD events, pass-1 steps on the
              first 10 chunks (counts, logits) and pass-2 logits on one
              segment. Prints pass-1/pass-2/VAD/punctuation latencies, the
              real-time factor, the batched pass-1 step at B = 1, 16, 64
              and a traced run of the session. The session's automaton
              runs natively (one library call a message); its input is
              replayed through the native and the plain automaton, online
              and offline: equal events, ms a message of each
  8. server   the websocket server with the batched StreamEngine
              (capacity 128), built by the launcher's build_models from
              the phase-3 and phase-7 model dirs with ChineseITN, on a
              real socket on 127.0.0.1, driven by the reference client's
              messages (its first JSON, 9600-sample frames,
              {"is_speaking": false}): 8a 64 connections paced at 600 ms
              a frame, each two bursts of 9.5-13.5 s after 2-4 s of
              digital silence (P8A_BURSTS; one in P8A_WRAP_EVERY led by
              silence so that its second segment's ring gather wraps);
              8b 128 unpaced connections of ~10 s; 8c a
              60 s offline upload; 8d a 10 s online stream. Gates: one
              is_final per connection, last; one non-empty pass-2 result
              per burst with timestamps in the reference schema inside
              its VAD segment; partials; connection c0's VAD segments
              equal a TwoPassSession's on the same chunks; the fp32
              kernel launched 50 times per pass-2 forward at bucket 256
              and nothing else; the offline result equal to
              OfflineRecognizer.transcribe; online partials only; one
              fused engine tick on the card and on the CPU; a 30 s
              8 kHz WAV upload, resampled once by the native library,
              equal to transcribe of linear_resample's samples; 8a's
              automatons all native. Prints tick, partial and final
              latency, the pass-2 lane's batches, audio-s/s, peak memory,
              vd_automaton p50/p95 and a traced window of 3 ticks;
              kernel #1 fp32 is timed at the lane's batch shape too
  9. hotword  9a: the deployed hotword model, paraformer_large(timestamp,
   and svs    hotword) with a converted HotwordConfig() compiler (no null
              row) and a seg_dict, saved as a dir and loaded through
              build_models; 20 compiled hotwords card vs CPU (1e-5);
              recognize_batch on 16 x 15 s (4 with 5 hotwords, 4 with 20,
              8 without) must run exactly 3 forwards and launch #1 fp32
              50 times each (the decoder's cross Tq = 136 is below the
              kernel's gate at bucket 256); one hotworded segment card vs
              CPU; compile ms for 20 and 200 hotwords; 16 x 60 s audio-s/s
              with and without hotwords (66 launches a forward).
              9b: sensevoice_small() + a 20-block tp stack as an svs dir;
              recognize_batch on 60, 150, 270 s must launch #1, #2, #3
              70 times each (T = 1028, 3076, 5124) and return meta ids;
              one 15 s segment card vs CPU (logits, greedy ids, beam-10
              n-best with a 5-word context graph) and the beam's host ms
              there; the native beam against its Python spec on 15 s and
              30 s, with and without the context (n-best ids and times
              equal, scores within 1e-4 or one fp32 step of the score;
              ms of each); 16 x 60 s greedy audio-s/s and a profile.
              9c: the server on the 9a models, --engine at capacity 128,
              16 paced connections, 8 with hotwords: one final per burst,
              embeddings in exactly the hotworded segments' forwards, c0's
              finals equal a create_session(hw_emb=...) session's.
              9d: the same launch with --svs-dir: svs_lang cycling zh,
              en, auto, 4 connections with hotwords; #1 fp32 launched 70
              times per pass-2 forward at T = 260; one native beam call
              per hotworded segment; a 60 s offline upload equal to
              OfflineRecognizer.transcribe. Prints latencies (beside the
              Python beam's) and the engine's idle share
 10. lm       n-gram LM rescoring, TLG graphs and FST ITN, with an LM the
              port's tools/build_lm trains on a corpus drawn from the seed
              over the Paraformer vocabulary's CJK tokens (Zipf, order 3)
              and tools/build_tlg compiles (per-token and --ctc-blank
              topologies; n-grams, states, arcs, bytes and build seconds
              printed), and a toy ITN grammar pair over every token that
              turns a third of them into digits.
              10a: phase 3's dir, 16 x 15 s in one recognize_batch with
              the native LM decoder: on the rows the card produced its
              texts equal the Python LmDecoder's, only the LM rows leave
              the card (bytes counted); with 5 hotwords a clone of it
              equals a decoder built with them; a TlgDecoder over
              build_tlg of the same LM gets rows gathered on the card equal
              to the host gather, and on the card's rows sharpened to an
              LM sentence TLG = native = Python = the sentence.
              10b: 9b's SenseVoice dir, 16 x 60 s, every 8th item with a
              TlgDecoder over the CTC graph: the other items equal a batch
              without LM, the LM items' words are the graph's, only their
              [T, labels] rows leave the card; a per-token graph is
              refused.
              10c: build_models with --engine --engine-capacity 128
              --lm-dir (the TLG dir) --itn-dir (the toy grammars): 8 paced
              connections, 4 with hotwords, and a 60 s offline upload; one
              TlgDecoder per connection over one graph, biased for the
              hotworded ones; every connection's finals equal a
              create_session session's with the same LM and hotwords, or
              differ only where the segment's TLG decision is a near-tie
              that the batch tips (the two best paths swap, their gaps
              within what the rows' difference allows; the differing
              texts, gaps and rows are printed), and the same sessions
              without the LM or the hotwords must fail that gate; the
              grammar's digits in the finals; one native TLG search per
              segment and two FST compositions per final; the upload equal
              to transcribe. Prints the native LM decoder against LmDecoder
              on 15 s and 60 s with and without hotwords, the TLG search a
              frame, FstITN a final, latencies and pass-2 stages
 11. int8,    11a: phase 5's weights cast to bf16 and quantized both
   fine-tune, ways (w8a8: torch._int_mm; w8a16): forwards at B=16,
   tools      T=1000 in bf16, w8a8 and w8a16 must launch #1 bf16 66
              times each (audio-s/s, idle share, greedy ids against
              bf16 printed); w8a8 at B=2, T=3072 and 5120 #2 and #3 50
              times each; _int_mm against bf16 and fp32 products at the
              encoder's shapes and one dense layer each way; the
              timestamp model in w8a8 (fp32) through recognize_batch 16
              x 60 s; every _int_mm shape of the path equal to the CPU's
              int32 product; card vs CPU on 15 s (w8a16: 1e-4 of the
              range; w8a8: within w8a8's own error against fp32), and
              each w8a8 layer shape of that forward card vs CPU on its
              own input (4 ulps of the output's range; a w8a16 product in
              its place must fall outside).
              11b: paraformer_large(timestamp) fp32, one B=2 loss and
              backward card vs CPU (loss 1e-4, gradient norms 1e-3); 20
              train_steps at B=8 x 15 s, U=60 (the loss must fall;
              steps/s, audio-s/s, peak memory); step 2 after restoring
              step 1's checkpoint = step 2 uninterrupted (1e-6); T=256
              under autograd must raise.
              11c: four seeded WAVs (one at 8 kHz): the transcribe CLI in
              its own process = transcribe in-process; eval_cer
              in-process = --server against the launcher's server;
              edit_align native = the Python DP on 1000 pairs (ms each)
 12. convert  (see phase12: the FunASR converter, the ONNX executor,
              fetch_model and the data-quality tools)
 13. parallel tensor and sequence parallelism on torch.distributed, on a
              world-size-1 NCCL group in this process, phase 3's dir:
              13a the tensor-parallel ParaformerOffline (1 x 1 mesh) on
              16 x 60 s + 150 s + 270 s against the unsharded one:
              encodings, alphas, token_num, logits and ids bit-equal,
              results equal, the same #1/#2/#3 launches (66/50/50);
              13b the sequence-parallel one on 300 s (T = 5000 past
              sp_threshold): encodings 1e-4 of their range, alphas
              1e-4, token_num equal, the logits measured (CIF carries
              the alphas' rounding along the segment); 13c two sharded
              training steps at B = 8 x 15 s (losses 1e-4); 13d the
              sharded prune on [16, 1028, 25055] logits (the whole
              prune's candidate sets); 13e #1/#2/#3 at the heads a rank
              holds at tp 2 and 4; 13g the recognizer given both
              meshes (tp 1 x sp 1) on 16 x 60 s + 150 s (TP: #1, #2)
              and the 300 s (SP), results equal to 13a's and 13b's, the
              encoder gather's ms and added memory; phase 11a's w8a16
              and w8a8 trees sharded (every unit whole): ids and logits
              equal to the unsharded int8 forward; a 3-head model (d
              384, head dim 128, 12 + 4 blocks) at tp 2 over two gloo
              ranks sharing the card, its attention whole: logits 1e-4
              of their range. With two or more cards, 13f: one
              NCCL rank a card, tp 2 and 4 (the same gates but the
              logits, and the sharded decoder on equal inputs 1e-4),
              sp over all, tp x sp over all (the TP results counted,
              the SP segment's length equal), the 3-head model at tp
              over all through the recognizer, dp x tp training,
              SenseVoice at vocab 25056 over tp (logits 1e-4, the
              sharded prune's sets). Alone:
              python3 chip_smoke.py --phase 13

 14. serving the launcher's servers as processes, on 9a's dir (phase 3's
   on       model with the hotword block) with phase 7's dirs: 14a
   several  --tp-devices 1 (rank 0 through the fan-out, no worker)
   cards    beside --tp-devices 0 on the same card: the 150 s and 270 s
            uploads (#2, #3), 8 x 10 s uploads with hotwords of their
            own and 4 paced connections 3 s apart (one final a burst)
            equal at tp 1 (finals, timestamps, partials), peak memory
            flat over the 8 recognizers, one shard a role, #1-#3
            launched; SenseVoice (9b's dir, no engine) likewise on an
            upload and a session; the fan-out's
            broadcasts, bytes and lock wait, latencies beside tp 0; 14b
            run_all_servers with a 2pass engine entry and an offline
            entry at tp_devices 1: answers equal to 14a's, a killed child
            restarted once, SIGTERM leaving no process; 14a-lane
            in-process engines at tp 1 and tp 0 fed in lockstep, so both
            decode the same lane batches (several chunks a call, wrapped
            ring gathers): results equal, ring features equal to the
            samples'. With two or more
            cards, 14c: --tp-devices 2 and 4 (worker ranks on NCCL; upload
            texts equal to the unsharded server's, timestamps counted),
            --sp-devices (300 s past --sp-threshold 4096: token count
            equal), --tp-devices with --sp-devices (4 x 4, 2 x 4: the
            150 s upload's text equal, the 300 s token count equal), a
            killed worker ending its server non-zero. Alone:
            python3 chip_smoke.py --phase 14 (or 14c); 14a's load
            control, two tp 1 and two tp 0 servers under uploads beside
            connections started together (agreement measured, not
            gated): python3 chip_smoke.py --phase 14x

Prints the card's name and power limit, one JSON line of the native
library's numbers ({"native": {...}}), one JSON line of kernel numbers
({"kernels": [...]}, with each kernel's launches on the offline path, in
the 2pass session, in the engine run and on phase 9's to 14's paths),
and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "asr2pass_tpu_torch/ops/attention.py"
# The profiler's CUPTI stays set up between traced windows. By default
# torch's Kineto tears CUPTI down after each window: a detached thread
# flushes it and waits while the next kernel launch, from whichever thread
# makes it, finalizes CUPTI inside its launch callback. The server phases
# close their windows while the engine's lanes launch from several
# threads, and whole runs died there with signal 11 (chip_repro_profiler
# shows the crash with the teardown on, and none without it). Set before
# torch is imported (chip_repro_10c imports this module first as well).
os.environ.setdefault("TEARDOWN_CUPTI", "0")
REPLACES = {
    "mh_flash_attention": "asr2pass_tpu/ops/attention.py:129",
    "_attention_ss": "asr2pass_tpu/ops/attention.py:261",
    "_attention_flash": "asr2pass_tpu/ops/attention.py:314",
}
# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W). fp32 work
# that keeps fp32 accuracy runs on the tensor cores as 3xTF32, three TF32
# products for each fp32 one (the fp32 kernel, and SDPA's mem-efficient
# kernel in fp32): 494.7 TFLOP/s / 3. The bound at the CUDA cores' 67
# TFLOP/s (the route of the earlier fp32 kernel) is printed beside it as
# bound_simt_ms. bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 494.7e12 / 3, "bfloat16": 989e12}
PEAK_SIMT_FP32 = 67e12
PEAK_BYTES = 3.35e12
# kernel vs its plain version evaluated in fp32 on the same input values.
# fp32: ops/attention.py's FP32_TOL, |kernel - plain| <= 1e-4 + 1e-4 *
# |plain|: fp32 summed in another order over up to 5120 keys, the products
# in 3xTF32. bf16: the limit of ops/attention.py's bf16_reference, 2^-8
# |plain| + 2^-6 sqrt(sum_j p_j^2 v_j^2) + 1e-6: the rounding of the output
# and of P before the P.V product, which the TPU kernels round too. The
# gate is the limit itself (share <= 1).
# Each case also holds negative controls to the same check: the plain
# result with each row's last valid key dropped (an off-by-one at the
# ragged edge) must fail it, in bf16 by CONTROL_BF16 times or more. In
# fp32 the TF32 control must fail it too: the plain result with q, k, v
# and P cut to TF32 as one TF32 wgmma reads an unsplit fp32 operand (its
# low 13 bits ignored, i.e. truncated), where the kernel takes three
# products of rounded parts. The same with round-to-nearest (tf32_split's
# hi) is printed beside it, not gated: over long rows its error averages
# out and it can read under 1 (PERF.md).
CONTROL_BF16 = 10.0
# card vs CPU on one 15 s segment, front-end included: logits within
# CPU_TOL of their range, CMVN features within FEATS_TOL. Both are fp32
# summed in other orders (TF32 off); the control run with TF32 products on
# must fail both limits
CPU_TOL = 1e-4
FEATS_TOL = 4e-3
FS = 16000
# phase 7: (digital silence before, speech-like burst) in seconds, then a
# tail of silence: ~59 s. Each burst makes a VAD segment of 128 < T_lfr <=
# 256 LFR frames (7.7-15.4 s), pass 2's bucket 256, under the VAD's 15 s
# cap (VadConfig.max_single_segment_time)
BURSTS = [(2.0, 9.5), (2.5, 12.0), (2.2, 13.5), (2.8, 10.5)]
TAIL_SILENCE = 4.0
MESSAGE = 9600            # samples a client message carries: 600 ms
PROFILE_MESSAGES = 25     # the traced session: 15 s, the first final
# a VAD segment starts within VAD_START_TOL_MS of the start its options
# predict for its burst. The prediction is the burst's onset less the
# 250 ms the automaton reaches back by design; the automaton's decibel
# frames, taken per message, also run up to 200 ms ahead of the
# posteriors (2 frames a 600 ms message, a behaviour of the reference)
VAD_START_TOL_MS = 300
# the VAD's energy gate: digital silence reads -60 dB (10 log10 of the
# 1e-6 floor), the bursts -14 dB at their quietest (the 0.01 noise floor)
VAD_DECIBEL_THRES = -30.0
# phase 8: the server. The reference client's first message
# (tests/test_protocol_replay.py:63-82) and its 9600-sample frames
# (chunk_size [5, 10, 5], chunk_interval 10); the launcher's default engine
# capacity; 64 paced connections of PACED_BURSTS each, 128 unpaced ones of
# ~10 s or more with one burst, one 60 s offline upload, one 10 s online stream
ENGINE_CAPACITY = 128
PACED_CONNECTIONS = 64
UNPACED_CONNECTIONS = 128
UNPACED_SECONDS = 10.0
ONLINE_SECONDS = 10.0
PACE_S = 0.6
VAD_TAIL_SIL_MS = 350
# the engine's traced windows (8a, 9c, 9d, 10c): a tick traces ~18k
# kernels, and reading them back takes seconds a tick
TRACE_TICKS = 3
TRACE_AT_S = 8.0          # the traced window opens this far into a paced run
PACED_BURSTS = 1          # 9c, 9d, 10c: bursts a paced connection
P8A_BURSTS = 2            # 8a: a second segment a connection, and a ring
P8A_WRAP_EVERY = 8        # gather that wraps: every 8th connection's
                          # second burst crosses the audio ring's end
UPLOAD_8K_SECONDS = 30.0  # 8c: an 8 kHz WAV upload, resampled to 16 kHz
# the native host library against its plain Python versions: the
# resampler on 60 s at two rates (interior limit: the JAX package's own,
# tests/test_native.py), the beam's scores (fp32 out of double sums: 1e-4
# or one fp32 step at the score's magnitude, see beam_gate)
RESAMPLE_SECONDS = 60.0
RESAMPLE_RATES = ((44100, 16000), (8000, 16000))
RESAMPLE_INTERIOR_TOL = 2e-4
BEAM_SCORE_TOL = 1e-4
# 9d with the Python beam (PERF.md section 6: NVIDIA H100 80GB HBM3,
# 700 W, three runs), printed beside this run's for comparison
PYTHON_BEAM_9D_MS = {"final_ms_p50": (10200, 12200),
                     "final_ms_p95": (16700, 18900),
                     "partial_ms_p50": (512, 551),
                     "partial_ms_p95": (5800, 7800)}


def reference_first_message(mode: str, wav_name: str, **fields) -> str:
    """The reference client's first message; `fields` replace some."""
    return json.dumps({
        "mode": mode, "chunk_size": [5, 10, 5], "chunk_interval": 10,
        "audio_fs": FS, "wav_name": wav_name, "wav_format": "pcm",
        "is_speaking": True, "hotwords": json.dumps({"阿里巴巴": 20}),
        "itn": True, "svs_itn": True, "vad_tail_sil": VAD_TAIL_SIL_MS,
        "vad_max_len": 20000, "svs_lang": "auto", **fields,
    })


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


class PhaseClock:
    """Seconds of each phase, split three ways: model build and load
    (`part("build")`: weights drawn, saved, loaded, converted; LMs and
    graphs built), the CPU reference work (`part("cpu")`: every run of a
    model or a decoder on the CPU that a card result is held against) and
    the rest, the card's work and its host side. Phases nest (a sub-phase
    counts toward its phase too); a part inside a part counts once."""

    def __init__(self):
        self.rows = {}
        self._open = []         # the open phases' rows, outermost first
        self._in_part = False

    @contextlib.contextmanager
    def phase(self, name: str):
        row = {"build_s": 0.0, "cpu_s": 0.0}
        self._open.append(row)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._open.pop()            # phases nest: this one is last
            row["total_s"] = time.perf_counter() - t0
            row["card_s"] = row["total_s"] - row["build_s"] - row["cpu_s"]
            self.rows[name] = row
            print(f"phase {name}: {row['total_s']:.1f} s (build and load "
                  f"{row['build_s']:.1f}, CPU reference {row['cpu_s']:.1f}, "
                  f"card {row['card_s']:.1f})", flush=True)

    @contextlib.contextmanager
    def part(self, kind):
        """kind "build" or "cpu"; None (a card iteration of a loop over
        both devices) counts as card work."""
        if kind is None or self._in_part or not self._open:
            yield
            return
        self._in_part = True
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._in_part = False
            for row in self._open:
                row[f"{kind}_s"] += dt


CLOCK = PhaseClock()


def on_cpu(dev) -> "str | None":
    """The clock's part for one device of a card-vs-CPU loop."""
    return "cpu" if str(dev) == "cpu" else None


# A SIGSEGV/SIGBUS/SIGILL/SIGFPE/SIGABRT handler that writes the faulting
# thread's native frames (library + offset) and its name. It is installed
# before faulthandler, which prints every Python thread's stack and then
# raises the signal again into this handler, so the native frames come
# last, where the end of the standard error shows them. faulthandler alone
# cannot show a thread that has no Python state (a CUDA runtime, profiler
# or OpenMP thread).
CRASH_TRACE_SRC = r"""
#include <execinfo.h>
#include <signal.h>
#include <string.h>
#include <sys/prctl.h>
#include <sys/syscall.h>
#include <unistd.h>

static struct sigaction g_prev[65];

static void put(const char* s) { ssize_t r = write(2, s, strlen(s)); (void)r; }
static void put_hex(unsigned long v) {
  char b[19] = "0x";
  for (int i = 0; i < 16; ++i) b[2 + i] = "0123456789abcdef"[(v >> (60 - 4 * i)) & 15];
  b[18] = 0;
  put(b);
}
static void put_dec(long v) {
  char b[24]; int n = 0; char t[24];
  if (v < 0) { put("-"); v = -v; }
  do { t[n++] = '0' + v % 10; v /= 10; } while (v);
  for (int i = 0; i < n; ++i) b[i] = t[n - 1 - i];
  b[n] = 0; put(b);
}

static void handler(int sig, siginfo_t* info, void*) {
  char name[17] = {0};
  prctl(PR_GET_NAME, name, 0, 0, 0);
  put("native crash: signal "); put_dec(sig);
  if (info->si_code > 0) {   // from the kernel: the faulting address
    put(" at address "); put_hex((unsigned long)info->si_addr);
  } else {                   // raised again by faulthandler's handler
    put(" (passed on by faulthandler)");
  }
  put(" in thread "); put_dec((long)syscall(SYS_gettid));
  put(" ("); put(name); put("); its native frames:\n");
  void* frames[64];
  int n = backtrace(frames, 64);
  backtrace_symbols_fd(frames, n, 2);
  // the default action ends the process: back in faulthandler's handler,
  // and from there the faulting instruction runs again
  sigaction(sig, &g_prev[sig], nullptr);
}

extern "C" int a2p_install_crash_trace(void) {
  void* warm[2];
  backtrace(warm, 2);           // load the unwinder outside a handler
  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO | SA_ONSTACK;
  sigemptyset(&sa.sa_mask);
  const int sigs[] = {SIGSEGV, SIGBUS, SIGILL, SIGFPE, SIGABRT};
  for (int s : sigs)
    if (sigaction(s, &sa, &g_prev[s]) != 0) return -1;
  return 0;
}
"""


def install_crash_trace() -> None:
    """Build CRASH_TRACE_SRC with g++ into a temporary directory and
    install its handler. Call it before faulthandler.enable(), which then
    hands each fatal signal on to it."""
    import ctypes
    import shutil

    cxx = shutil.which("g++")
    if cxx is None:
        fail("no g++ to build the native crash trace")
    out = os.path.join(tempfile.mkdtemp(prefix="crash_trace_"), "trace.so")
    src = out[:-3] + ".cc"
    with open(src, "w") as f:
        f.write(CRASH_TRACE_SRC)
    res = subprocess.run([cxx, "-O1", "-fPIC", "-shared", src, "-o", out],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"the native crash trace does not build: {res.stderr}")
    lib = ctypes.CDLL(out)
    if lib.a2p_install_crash_trace() != 0:
        fail("the native crash trace did not install")
    # the library stays loaded for the process (ctypes keeps it mapped)
    globals()["_CRASH_TRACE"] = lib


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """ms per call of fn: CUDA events around `iters` back-to-back calls.
    Where the host takes longer to enqueue a call than the device takes to
    run it, this is the host's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int) -> tuple:
    """(device ms, host ms) per call of fn. The device time is taken by
    CUDA events around `iters` calls queued behind a spin kernel, so the
    calls run back to back on the device whatever the host's pace; the
    host time is the host's clock around the enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e9 cycles a second: hold the device while the host enqueues
    torch.cuda._sleep(int(min(2e9, 2.4e9 * once * iters)))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


F32_STEPS = (("pre-pass", "attention_kernel_f32_presplit"),
             ("main", "attention_kernel_f32_sm90"),
             ("combine", "attention_kernel_f32_combine"))


def f32_step_ms(fn, iters: int = 10) -> dict:
    """Device ms a call of fn in each launch of the fp32 kernel (its
    pre-pass, main kernel and combine), from a profiler trace of `iters`
    calls; None where the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {label: 0.0 for label, _ in F32_STEPS}
    seen = False
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        for label, name in F32_STEPS:
            if name in e.key:
                times[label] += e.device_time_total / 1e3 / iters
                seen = True
    return times if seen else None


def ptxas_usage(log: str) -> list:
    """Registers, stack and spills of each compiled kernel from nvcc's
    ptxas report, with its dynamic shared memory per block (from the
    kernel's source, through the library)."""
    import re

    import torch

    from asr2pass_tpu_torch.ops import attention as att

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*?(attention_kernel"
                      r"(_f32)?_sm90)ILi(\d+)E", ln)
        other = re.search(r"Function properties for \S*?(attention_kernel"
                          r"_f32_(presplit|combine))(ILi(\d+)E)?", ln)
        if m:
            kernel, fp32, d = m.group(1), m.group(2), int(m.group(3))
            smem = att.smem_bytes(torch.float32 if fp32 else torch.bfloat16,
                                  d)
            name = f"{kernel}<{d}> smem {smem} B"
            stats = []
        elif other:   # the fp32 kernel's pre-pass and combine
            name = other.group(1) + (f"<{other.group(4)}>"
                                     if other.group(4) else "")
            stats = []
        elif name and ("spill" in ln or "registers" in ln):
            stats.append(ln.split(":", 1)[-1].strip())
            if "registers" in ln:
                out.append(f"{name}, {'; '.join(stats)}")
                name = None
    # ptxas's performance warnings (C7512/C7513: wgmma serialised)
    out += [ln.split("ptxas info    : ")[-1][:160] for ln in log.splitlines()
            if "(C75" in ln]
    return out


def device_profile(fn, label: str, host_ops: bool = True) -> dict:
    """One traced run of fn: wall time, the device's busy time (the sum of
    its kernels' times; one stream, so they do not overlap), its idle
    share, and the kernels that took the most device time. host_ops=False
    traces the device alone, which keeps a long run's trace small."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms == 0:
        print(f"profile: {label}: device time not measured (the trace "
              f"holds no kernel)", flush=True)
        return {"wall_ms": wall_ms, "busy_ms": None}
    # attention_kernel (fp32) and attention_kernel_sm90 (bf16); NCCL's
    # collectives (ncclDevKernel_*)
    att_ms = sum(ms for name, ms, _ in kernels if "attention_kernel" in name)
    nccl_ms = sum(ms for name, ms, _ in kernels if "nccl" in name.lower())
    n_launch = sum(n for _, _, n in kernels)
    print(f"profile: {label}: wall {wall_ms:.1f} ms (traced), device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_launch} kernel launches, attention kernel {att_ms:.1f} ms "
          f"({att_ms / busy_ms:.3f} of busy), collectives {nccl_ms:.1f} ms "
          f"({nccl_ms / busy_ms:.3f} of busy)", flush=True)
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        print(f"profile:   {ms:9.3f} ms {n:7d}x {name[:100]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "attention_ms": att_ms,
            "nccl_ms": nccl_ms, "launches": n_launch}


# ---------------------------------------------------------------------------
# the native host library: each part against its plain Python version on
# the card's host
# ---------------------------------------------------------------------------

def host_ms(fn, reps: int):
    """(fn's result, median host ms of reps calls)."""
    import numpy as np

    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def resample_gate(card: str) -> dict:
    """The native resampler against its numpy plain version on
    RESAMPLE_SECONDS of audio at each of RESAMPLE_RATES: lengths within
    1, the interior within RESAMPLE_INTERIOR_TOL; ms of each path."""
    import numpy as np

    from asr2pass_tpu_torch.frontend.audio import linear_resample
    from asr2pass_tpu_torch.native import bindings as nb

    out = {}
    for fs_in, fs_out in RESAMPLE_RATES:
        rng = np.random.default_rng(fs_in)
        n = int(RESAMPLE_SECONDS * fs_in)
        t = np.arange(n) / fs_in
        x = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        nb.reset_call_counts()
        nat, nat_ms = host_ms(lambda: linear_resample(x, fs_in, fs_out), 5)
        calls = nb.call_counts()["resample"]
        plain, plain_ms = host_ms(
            lambda: linear_resample(x, fs_in, fs_out, native=False), 3)
        m = min(len(nat), len(plain))
        err = float(np.abs(nat[100:m - 100] - plain[100:m - 100]).max())
        key = f"{fs_in}->{fs_out}"
        out[key] = {"native_ms": nat_ms, "plain_ms": plain_ms,
                    "plain_over_native": plain_ms / nat_ms,
                    "samples": [len(nat), len(plain)],
                    "interior_max_abs_err": err,
                    "identical": bool(len(nat) == len(plain)
                                      and np.array_equal(nat, plain))}
        print(f"native: resample {RESAMPLE_SECONDS:.0f} s {key}: native "
              f"{nat_ms:.2f} ms, numpy {plain_ms:.2f} ms "
              f"({plain_ms / nat_ms:.1f}x), lengths {len(nat)}/"
              f"{len(plain)}, interior max |err| {err:.3e} (limit "
              f"{RESAMPLE_INTERIOR_TOL}), identical "
              f"{out[key]['identical']}; {calls} native calls on {card}",
              flush=True)
        if (calls != 5 or abs(len(nat) - len(plain)) > 1
                or not err <= RESAMPLE_INTERIOR_TOL):
            fail(f"native: resample {key} differs from its numpy version "
                 f"or did not run natively: {out[key]}, {calls} calls")
    return out


def automaton_gate(calls: list, opts, session_events: list,
                   card: str) -> dict:
    """Replay a VAD stream's automaton input (posteriors, waveform
    chunks, flags and overrides, one call a message) through the native
    automaton and the plain Python one, online and offline: the events
    must be equal, and the online native replay must give the events the
    stream gave. ms a message of each path."""
    import dataclasses

    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.vad.e2e_vad import E2EVadStateMachine

    out = {"messages": len(calls)}
    for online in (True, False):
        events, ms = {}, {}
        for native in (True, False):
            # a copy: the plain path writes the max_single_segment_time
            # override into its options
            sm = E2EVadStateMachine(dataclasses.replace(opts), native=native)
            evs, times = [], []
            nb.reset_call_counts()
            for scores, samples, kw in calls:
                t0 = time.perf_counter()
                evs += sm(scores, samples, **dict(kw, online=online))
                times.append((time.perf_counter() - t0) * 1e3)
            n_calls = nb.call_counts()["vad_chunk"]
            sm.close()
            if n_calls != (len(calls) if native else 0):
                fail(f"native: automaton replay made {n_calls} native "
                     f"calls for {len(calls)} messages (native {native})")
            events[native], ms[native] = evs, sum(times) / len(times)
        mode = "online" if online else "offline"
        out[mode] = {"native_ms_per_message": ms[True],
                     "plain_ms_per_message": ms[False],
                     "plain_over_native": ms[False] / ms[True],
                     "events": len(events[True])}
        print(f"native: automaton replay, {len(calls)} messages {mode}: "
              f"events equal {events[True] == events[False]} "
              f"({len(events[True])}); ms a message native "
              f"{ms[True]:.4f}, plain {ms[False]:.4f} "
              f"({ms[False] / ms[True]:.1f}x) on {card}", flush=True)
        if events[True] != events[False] or not events[True]:
            fail(f"native: automaton events differ ({mode}): native "
                 f"{events[True]}, plain {events[False]}")
        if online and events[True] != session_events:
            fail(f"native: the replayed events {events[True]} differ from "
                 f"the session's {session_events}")
    return out


def beam_gate(label: str, cid, clp, length: int, context, vocab,
              card: str) -> dict:
    """The native pruned beam (beam SVS_BEAM) against its Python spec
    (use_native=False) on one segment's candidates: n-best ids and times
    equal, scores within BEAM_SCORE_TOL; ms of each path."""
    import numpy as np

    from asr2pass_tpu_torch.decode.ctc import ctc_prefix_beam_search_pruned
    from asr2pass_tpu_torch.native import bindings as nb

    kw = dict(beam=SVS_BEAM, context=context, id_to_token=vocab.id2token,
              token2id=vocab.token2id)
    nb.reset_call_counts()
    nat, nat_ms = host_ms(lambda: ctc_prefix_beam_search_pruned(
        cid, clp, length, **kw), 5)
    calls = nb.call_counts()["ctc_beam_decode"]
    plain, plain_ms = host_ms(lambda: ctc_prefix_beam_search_pruned(
        cid, clp, length, use_native=False, **kw), 1)
    same = ([h[0] for h in nat] == [h[0] for h in plain]
            and [h[2] for h in nat] == [h[2] for h in plain])
    # the library returns fp32 scores of double sums: a score is held to
    # BEAM_SCORE_TOL or, where its magnitude makes one fp32 step larger
    # (a biased 60 s segment scores in the thousands), to one step
    diffs = [abs(a[1] - b[1]) for a, b in zip(nat, plain)]
    limits = [max(BEAM_SCORE_TOL, float(np.spacing(np.float32(abs(b[1])))))
              for b in plain]
    score_err = max(diffs, default=float("inf"))
    fp32_equal = all(np.float32(b[1]) == np.float32(a[1])
                     for a, b in zip(nat, plain))
    print(f"native: beam {SVS_BEAM}, {label}: {length} frames x "
          f"{cid.shape[1]} candidates; n-best ids and times equal {same}, "
          f"max score diff {score_err:.3e} (limits {min(limits):.1e}-"
          f"{max(limits):.1e}: {BEAM_SCORE_TOL} or one fp32 step of the "
          f"score; best score {plain[0][1]:.3f}), scores equal in fp32 "
          f"{fp32_equal}; native {nat_ms:.2f} ms, Python {plain_ms:.1f} ms "
          f"({plain_ms / nat_ms:.1f}x); {calls} native calls on {card}",
          flush=True)
    if not (same and nat and calls == 5
            and all(d <= lim for d, lim in zip(diffs, limits))):
        fail(f"native: beam {label} differs from its Python spec or did "
             f"not run natively ({calls} calls)")
    return {"native_ms": nat_ms, "plain_ms": plain_ms,
            "plain_over_native": plain_ms / nat_ms, "frames": length,
            "candidates": int(cid.shape[1]), "max_score_diff": score_err,
            "best_score": plain[0][1], "scores_equal_in_fp32": fp32_equal}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _lengths(b: int, t: int, gen, meta: int = 0):
    """Key lengths of a pass-2 batch at T = t: its bucket is t - meta
    (SenseVoice's encoder runs over meta = 4 prefix rows + the frames)."""
    import torch

    bucket = t - meta
    if b == 1:             # one pass-2 segment of its bucket: t/2 < T <= t
        return meta + torch.randint(bucket // 2 + 1, bucket + 1, (1,),
                                    generator=gen, device="cuda")
    lens = meta + torch.randint(bucket // 4, bucket + 1, (b,), generator=gen,
                                device="cuda")
    lens[0] = t
    lens[-1] = meta        # a batch-bucket padding row: only the meta rows
    return lens


def _mask(lens, t):
    import torch

    return (torch.arange(t, device="cuda")[None, :]
            < lens[:, None]).float()


def _tol_ratio(got, ref, limit) -> float:
    """max |got - ref| / limit over the elements: at most 1 passes."""
    return ((got.float() - ref).abs() / limit).max().item()


def kernel_case(name, shape, dtype, gen, meta: int = 0):
    """One (entry point, shape, dtype) measurement; meta = 4 draws
    SenseVoice's lengths (see _lengths). Returns a dict with the JSON keys
    of the kernels line."""
    import torch
    import torch.nn.functional as F

    from asr2pass_tpu_torch.ops import attention as att

    dt = getattr(torch, dtype)
    es = torch.empty(0, dtype=dt).element_size()
    if name == "mh_flash_attention":
        b, tq, tk, d, h = shape
        dk = d // h
        if tq == tk:   # self-attention: q and k|v are slices of one qkv
            qkv = torch.randn(b, tq, 3 * d, generator=gen, device="cuda",
                              dtype=dt)
            q, kv = qkv[..., :d], qkv[..., d:]
        else:
            q = torch.randn(b, tq, d, generator=gen, device="cuda", dtype=dt)
            kv = torch.randn(b, tk, 2 * d, generator=gen, device="cuda",
                             dtype=dt)
        lens = _lengths(b, tk, gen, meta)
        mask = _mask(lens, tk)
        run = lambda: att.mh_flash_attention(q, kv, mask, h)
        plain = lambda: att.mh_attention_plain(q, kv, mask, h)
        plain32 = lambda kv_mask, rnd=None: att.mh_attention_plain(
            q.float(), kv.float(), kv_mask, h, operand_round=rnd)
        reference = lambda: att.mh_bf16_reference(q, kv, mask, h)
        qh = q.unflatten(-1, (h, dk)).transpose(1, 2)
        kh = kv[..., :d].unflatten(-1, (h, dk)).transpose(1, 2)
        vh = kv[..., d:].unflatten(-1, (h, dk)).transpose(1, 2)
        zero_rows = None
        # no query rows are zeroed: every row attends to its valid keys
        flops = 4 * tq * d * int(lens.sum())
        nbytes = (2 * b * tq * d + 2 * b * tk * d) * es + 4 * b * tk
    else:
        b, h, t, d = shape
        qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda",
                          dtype=dt)
        # the main path's layout: split-head views of one fused projection
        qh, kh, vh = (a.unflatten(-1, (h, d)).transpose(1, 2)
                      for a in qkv.split(h * d, dim=-1))
        lens = _lengths(b, t, gen, meta)
        mask = _mask(lens, t)
        fn = getattr(att, name)
        run = lambda: fn(qh, kh, vh, mask) if name == "_attention_flash" \
            else fn(qh, kh, vh, mask, mask)
        plain = lambda: att.attention_plain(qh, kh, vh, mask, mask)
        plain32 = lambda kv_mask, rnd=None: att.attention_plain(
            qh.float(), kh.float(), vh.float(), kv_mask, mask,
            operand_round=rnd)
        reference = lambda: att.bf16_reference(qh, kh, vh, mask, mask)
        zero_rows = lens == 0
        # rows whose query mask is 0 come out as 0: only valid x valid
        flops = 4 * h * d * int((lens * lens).sum())
        nbytes = 4 * b * h * t * d * es + 4 * b * t
    got = run()
    if dtype == "bfloat16":
        ref, limit = reference()
        tol = "bf16_reference"
    else:
        ref = plain32(mask)
        limit = att.FP32_TOL[0] + att.FP32_TOL[1] * ref.abs()
        tol = str(att.FP32_TOL)
    # negative control: each row's last valid key dropped
    drop = mask.clone()
    rows = torch.nonzero(lens > 0).flatten()
    drop[rows, lens[rows] - 1] = 0
    control = plain32(drop).to(dt)
    # fp32: the TF32 controls, one TF32 product where the kernel takes
    # three, with the operands truncated (gated) or rounded (printed)
    tf32 = tf32_rna = None
    if dtype == "float32":
        tf32 = plain32(mask, lambda x: (x.view(torch.int32) & ~0x1FFF)
                       .view(torch.float32))
        tf32_rna = plain32(mask, lambda x: att.tf32_split(x)[0])
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name} {shape} {dtype}: non-finite output")
    if (zero_rows is not None and bool(zero_rows.any())
            and got[zero_rows].abs().max().item() != 0):
        fail(f"{name} {shape} {dtype}: length-0 rows are not exactly 0")
    err = (got.float() - ref).abs().max().item()
    ratio = _tol_ratio(got, ref, limit)
    control_ratio = _tol_ratio(control, ref, limit)
    # the share read by the fp32 result rounded once to the output dtype:
    # what any kernel that stores in that dtype reads at least
    rounded_ratio = _tol_ratio(ref.to(dt), ref, limit)
    tf32_ratio = None if tf32 is None else _tol_ratio(tf32, ref, limit)
    tf32_rna_ratio = (None if tf32_rna is None
                      else _tol_ratio(tf32_rna, ref, limit))
    control_min = CONTROL_BF16 if dtype == "bfloat16" else 1.0
    if not ratio <= 1:
        fail(f"{name} {shape} {dtype}: max |kernel - plain| {err:.3e}, "
             f"{ratio:.3f} of tolerance {tol}")
    if not control_ratio > control_min:
        fail(f"{name} {shape} {dtype}: the dropped-key control reads "
             f"{control_ratio:.3f} of tolerance {tol}, not over "
             f"{control_min}")
    if tf32_ratio is not None and not tf32_ratio > 1:
        fail(f"{name} {shape} {dtype}: the TF32 control reads "
             f"{tf32_ratio:.3f} of tolerance {tol}, not over 1")
    del ref, limit, control, tf32, tf32_rna
    # the plain version as it runs on these tensors (bf16 probabilities
    # and output in bf16): printed for reference, not a gate
    plain_err = (got.float() - plain().float()).abs().max().item()
    big = b * max(shape[1:3]) >= 8192
    iters = 5 if big else 20
    sdpa_mask = (mask > 0)[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=sdpa_mask)
    t_flops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    times = {}
    for key, call in (("", run), ("plain_", plain), ("library_", library)):
        times[f"{key}ms"] = time_ms(call, iters)
        times[f"{key}device_ms"], times[f"{key}host_ms"] = \
            device_time_ms(call, iters)
    sched = steps = None
    if dtype == "float32":
        # the fp32 kernel's schedule at this shape, and where its device
        # time goes: pre-pass, main kernel, combine
        s = att.f32_schedule(qh.shape[0], qh.shape[1], qh.shape[2],
                             kh.shape[2], qh.shape[3],
                             att._sm_count(torch.cuda.current_device()))
        sched = {"splits": s.splits, "grid_main": list(s.grid_main),
                 "d_inst": s.d_inst, "scratch_bytes": s.scratch_bytes}
        steps = f32_step_ms(run)
    return {
        "schedule": sched, "steps_ms": steps,
        "shape": list(shape), "dtype": dtype,
        "max_abs_err": err,
        "tolerance": tol,
        "tol_ratio": ratio, "control_tol_ratio": control_ratio,
        "rounded_once_tol_ratio": rounded_ratio,
        "tf32_control_tol_ratio": tf32_ratio,
        "tf32_rna_control_tol_ratio": tf32_rna_ratio,
        "max_abs_err_vs_plain_in_dtype": plain_err,
        **times,
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "bound_simt_ms": (max(flops / PEAK_SIMT_FP32, t_bytes) * 1e3
                          if dtype == "float32" else None),
        "flops": flops, "bytes": nbytes,
    }


def print_case(name, r, tag: str = "") -> None:
    tf32 = r["tf32_control_tol_ratio"]
    tf32 = "" if tf32 is None else (
        f"; TF32 control {tf32:.3f} (rounded to nearest "
        f"{r['tf32_rna_control_tol_ratio']:.3f}, not gated)")
    simt = r["bound_simt_ms"]
    simt = "" if simt is None else \
        f" (at the CUDA cores' fp32 rate {simt:.4f})"
    if r.get("schedule"):
        steps = r["steps_ms"]
        simt += (f"; schedule: {r['schedule']['splits']} key splits, grid "
                 f"{r['schedule']['grid_main']}, d {r['schedule']['d_inst']}"
                 "; device ms pre-pass / main / combine: " + (
                     " / ".join(f"{v:.4f}" for v in steps.values())
                     if steps else "not measured"))
    print(f"kernel {name} {r['shape']} {r['dtype']}{tag}: "
          f"max_abs_err {r['max_abs_err']:.3e} "
          f"({r['tol_ratio']:.3f} of tolerance, fp32 result "
          f"rounded once {r['rounded_once_tol_ratio']:.3f}; "
          f"dropped-key control {r['control_tol_ratio']:.1f}"
          f"{tf32}; "
          f"vs the plain version in {r['dtype']} "
          f"{r['max_abs_err_vs_plain_in_dtype']:.3e}), "
          f"ms back to back / device / host: kernel "
          f"{r['ms']:.4f} / {r['device_ms']:.4f} / "
          f"{r['host_ms']:.4f}, plain {r['plain_ms']:.4f} / "
          f"{r['plain_device_ms']:.4f} / {r['plain_host_ms']:.4f}, "
          f"sdpa {r['library_ms']:.4f} / "
          f"{r['library_device_ms']:.4f} / "
          f"{r['library_host_ms']:.4f}; bound {r['bound_ms']:.4f} "
          f"by {r['bound_by']}{simt}", flush=True)


# SenseVoice's encoder runs over 4 meta rows + the bucket, fp32: #1 at the
# engine lane's T = 260 (B = 16), one 60 s upload and the 16 x 60 s batch
# (T = 1028), #2 at a 150 s upload (T = 3076), #3 at 270 s (T = 5124)
SVS_KERNEL_CASES = [("mh_flash_attention", (16, 260, 260, 512, 4)),
                    ("mh_flash_attention", (1, 1028, 1028, 512, 4)),
                    ("mh_flash_attention", (16, 1028, 1028, 512, 4)),
                    ("_attention_ss", (1, 4, 3076, 128)),
                    ("_attention_flash", (1, 4, 5124, 128))]


# the fp32 kernel's schedules that the main path's shapes do not reach
# (f32_schedule at 132 SMs): 16 key splits (a cross-attention of 128 rows
# over 2048 keys), and the head-dim instantiations 64 (2-stage rings), 32
# (4 stages) and 256 (32-key tiles, 64-row blocks); B = 2, so each has a
# row of no valid key (length 0)
SCHEDULE_CASES = [("mh_flash_attention", (2, 128, 2048, 128, 1)),
                  ("_attention_ss", (2, 4, 1024, 64)),
                  ("_attention_ss", (2, 4, 1024, 32)),
                  ("_attention_ss", (2, 2, 1024, 256))]


def kernel_phase(gen):
    """Returns ({entry point: [runs]}, [SenseVoice runs]); a SenseVoice
    run carries its entry point as "name"."""
    cases = {
        # main path: encoder self-attention at bucket 1024, decoder cross
        # with Tq = 1024//2+8; split-head at bucket 3072; long at 5120.
        # #3 takes B=2 so that it, too, has a length-0 row. The 2pass
        # path: pass 2's encoder on one segment of bucket 256.
        "mh_flash_attention": [(16, 1024, 1024, 512, 4),
                               (16, 520, 1024, 512, 4),
                               (1, 256, 256, 512, 4),
                               (16, 256, 256, 512, 4)],
        "_attention_ss": [(2, 4, 3072, 128)],
        "_attention_flash": [(2, 4, 5120, 128)],
    }
    results = {}
    for name, shapes in cases.items():
        runs = [kernel_case(name, s, dt, gen)
                for dt in ("float32", "bfloat16") for s in shapes]
        results[name] = runs
        for r in runs:
            print_case(name, r)
    svs = []
    for name, shape in SVS_KERNEL_CASES:
        r = dict(kernel_case(name, shape, "float32", gen, meta=4),
                 name=name, path="sensevoice")
        print_case(name, r, " (SenseVoice: 4 meta rows)")
        svs.append(r)
    for name, shape in SCHEDULE_CASES:
        r = dict(kernel_case(name, shape, "float32", gen), name=name,
                 path="schedule")
        print_case(name, r, " (a schedule off the main path)")
        svs.append(r)
    sdpa_route()
    return results, svs


def sdpa_route() -> None:
    """Print, once, the kernels that torch's scaled_dot_product_attention
    runs for fp32 with a boolean mask, as the kernel phase calls it: the
    route of the yardstick."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = torch.randn(2, 4, 1024, 128, device="cuda")
    mask = torch.ones(2, 1, 1, 1024, dtype=torch.bool, device="cuda")
    F.scaled_dot_product_attention(q, q, q, attn_mask=mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, q, q, attn_mask=mask)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    route = " | ".join(n[:120] for n in names) or \
        "not measured (the trace holds no kernel)"
    print(f"kernel: sdpa fp32 route: {route}", flush=True)


# ---------------------------------------------------------------------------
# phase 3-5: the main path
# ---------------------------------------------------------------------------

def synth_audio(seconds: float, seed: int):
    """Seeded speech-like test signal: a gliding harmonic tone under a
    ~4 Hz syllable envelope, plus noise, in [-1, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t
                            + rng.uniform(0, 2 * np.pi)))
    f0 = rng.uniform(100, 250) * (1 + 0.2 * np.sin(2 * np.pi * 0.3 * t))
    phase = 2 * np.pi * np.cumsum(f0) / FS
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x = 0.15 * env * x + 0.01 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def save_model_dir(model_dir: str, gen):
    """Phase 3's dir: paraformer_large with the timestamp head, weights
    drawn from gen on the card, saved through the model zoo. Returns its
    configuration."""
    import numpy as np

    from asr2pass_tpu_torch.config import paraformer_large
    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.runtime.model_zoo import save_offline_bundle

    cfg = paraformer_large(timestamp=True)
    model = paraformer.init(cfg, gen, "cuda")
    tokens = ["<blank>", "<s>", "</s>", "<unk>"] + [
        chr(0x4E00 + i) for i in range(cfg.vocab_size - 4)]
    d = cfg.frontend.lfr_dim
    cmvn = (np.full(d, -12.0, np.float32), np.full(d, 0.25, np.float32))
    save_offline_bundle(model_dir, model, cfg, tokens, cmvn)
    return cfg


def main_path(model_dir: str, gen, card: str):
    import torch

    from asr2pass_tpu_torch.config import paraformer_large
    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.utils import cast_floats

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        cfg = save_model_dir(model_dir, gen)
        bundle = load_offline_bundle(model_dir)
        asr = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                                cmvn=bundle.cmvn)
    rec = OfflineRecognizer(asr)
    n_params = sum(p.numel() for p in asr.model.parameters())
    print(f"main: paraformer_large(timestamp=True), {n_params} params, "
          f"init+save+load {time.perf_counter() - t0:.1f} s", flush=True)

    # every forward of the main path must give finite outputs
    forward = asr._forward

    def checked_forward(*a, **kw):
        out = forward(*a, **kw)
        for name in ("logits", "alphas", "us_alphas", "us_cif_peak"):
            if not torch.isfinite(getattr(out, name)).all():
                fail(f"main path: non-finite {name}")
        return out

    asr._forward = checked_forward
    fcfg = cfg.frontend
    requests = [(60.0, 1), (150.0, 2), (270.0, 3)]
    audio = {s: synth_audio(s, seed) for s, seed in requests}
    torch.cuda.synchronize()
    att.reset_launch_counts()
    for seconds, _ in requests:
        t1 = time.perf_counter()
        res = rec.transcribe(audio[seconds])
        dt = time.perf_counter() - t1
        if not res.text or not res.timestamps:
            fail(f"transcribe {seconds} s: empty text or timestamps")
        # stamps end at most at the last LFR frame (60 ms each)
        n_mel = 1 + (int(seconds * FS) - fcfg.frame_length) \
            // fcfg.frame_shift
        end_ms = -(-n_mel // fcfg.lfr_n) * fcfg.lfr_n * fcfg.frame_shift_ms
        if any(not 0 <= b <= e <= end_ms for b, e in res.timestamps):
            fail(f"transcribe {seconds} s: timestamps out of range")
        print(f"main: transcribe {seconds:.0f} s -> {len(res.text)} chars, "
              f"{len(res.timestamps)} stamps, {dt:.2f} s", flush=True)
    launches = att.launch_counts()
    by_dtype = {"float32": {k: v["float32"] for k, v in
                            att.launch_counts_by_dtype().items()}}
    print(f"main: kernel launches {launches}", flush=True)
    # bucket 1024: 50 encoder + 16 decoder cross; 3072 and 5120: encoder
    expected = {"mh_flash_attention": 66, "_attention_ss": 50,
                "_attention_flash": 50}
    for name, n in expected.items():
        if launches[name] != n or by_dtype["float32"][name] != n:
            fail(f"main path launched {name} {launches[name]} times "
                 f"({by_dtype['float32'][name]} in float32), expected {n}")
    asr._forward = forward

    # phase 4: the same 15 s segment through the front-end and the forward
    # on the card and on the CPU (plain versions), same weights
    seg = synth_audio(15.0, 4)
    n_mel = 1 + (len(seg) - fcfg.frame_length) // fcfg.frame_shift
    t_lfr = -(-n_mel // fcfg.lfr_n)

    def segment(rec_, device):
        feats = offline_frontend_device([seg], [n_mel], 256, fcfg,
                                        *bundle.cmvn, batch_b=1,
                                        device=device)
        with torch.inference_mode():
            out = rec_._forward(feats, [t_lfr])
        return feats.cpu(), int(out.token_num[0]), out.logits[0].cpu()

    with CLOCK.part("cpu"):
        cpu = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                                cmvn=bundle.cmvn, device="cpu")
        feats_c, n_tok, logits_c = segment(cpu, "cpu")
        del cpu
    lc = logits_c[:n_tok]
    scale = max(1.0, lc.abs().max().item())
    limit = CPU_TOL * scale

    def compare(label):
        feats_g, n_g, logits_g = segment(asr, "cuda")
        feat_err = (feats_g - feats_c).abs().max().item()
        err = ((logits_g[:n_tok] - lc).abs().max().item()
               if n_g == n_tok else float("inf"))
        print(f"cpu: 15 s segment T={t_lfr} {label}: token_num card {n_g}, "
              f"cpu {n_tok}; max |feats card - cpu| {feat_err:.3e} (limit "
              f"{FEATS_TOL}); max "
              f"|logits card - cpu| {err:.3e} (limit {limit:.3e})",
              flush=True)
        return err, feat_err

    cpu_err, cpu_feat_err = compare("TF32 off")
    if not cpu_err <= limit:
        fail(f"card vs cpu logits differ by {cpu_err:.3e} (limit {limit})")
    if not cpu_feat_err <= FEATS_TOL:
        fail(f"card vs cpu features differ by {cpu_feat_err:.3e} (limit "
             f"{FEATS_TOL})")
    # control: the same run with TF32 products must fail the limit, or the
    # check could not see the reduced precision it guards against
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_err, tf32_feat_err = compare("control, TF32 on")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not (tf32_err > limit and tf32_feat_err > FEATS_TOL):
        fail(f"the TF32 control passes a card vs cpu limit (logits "
             f"{tf32_err:.3e}, limit {limit:.3e}; features "
             f"{tf32_feat_err:.3e}, limit {FEATS_TOL})")

    # phase 5: throughput
    batch = [synth_audio(60.0, 100 + i) for i in range(16)]
    iters = 3
    asr.recognize_batch(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(iters):
        asr.recognize_batch(batch)
    rec_s = (time.perf_counter() - t1) / iters
    rec_rate = 16 * 60.0 / rec_s
    print(f"speed: recognize_batch 16 x 60 s fp32: {rec_s * 1e3:.1f} ms, "
          f"{rec_rate:.1f} audio-s/s on {card}", flush=True)
    # phase 6: where the device time goes in the fp32 recognizer
    device_profile(lambda: asr.recognize_batch(batch),
                   "recognize_batch 16 x 60 s fp32")

    # bench.py's offline shape: paraformer_large without the timestamp
    # head, bf16, 16 x 60 s at full length
    bench_cfg = paraformer_large()
    t_b = int(60.0 * 1000 / (fcfg.frame_shift_ms * fcfg.lfr_n))
    model16 = cast_floats(asr.model, torch.bfloat16)
    feats16 = torch.randn(16, t_b, fcfg.lfr_dim, generator=gen,
                          device="cuda").to(torch.bfloat16)
    lens16 = torch.full((16,), t_b, dtype=torch.long, device="cuda")

    def bench_forward(feats=feats16, lens=lens16):
        with torch.inference_mode():
            out = paraformer.apply(model16, bench_cfg, feats, lens,
                                   max_tokens=feats.shape[1] // 2 + 8)
            if not torch.isfinite(out.logits).all():
                fail(f"bf16 forward {tuple(feats.shape)}: non-finite "
                     "logits")
            return paraformer.greedy_ids(out)[1].cpu()

    # the bf16 kernel on the model path: one bench-shape forward (encoder
    # 50 + decoder cross 16 at T=1000), then B=2 at T=3072 and 5120 (the
    # encoder's split-head entry points, 50 each)
    bf16 = {}
    for b_, t_, entry in [(16, t_b, "mh_flash_attention"),
                          (2, 3072, "_attention_ss"),
                          (2, 5120, "_attention_flash")]:
        if b_ == 16:
            feats, lens = feats16, lens16
        else:
            feats = torch.randn(b_, t_, fcfg.lfr_dim, generator=gen,
                                device="cuda").to(torch.bfloat16)
            lens = torch.tensor([t_, t_ * 3 // 5], device="cuda")
        torch.cuda.synchronize()
        att.reset_launch_counts()
        bench_forward(feats, lens)
        torch.cuda.synchronize()
        counts = att.launch_counts_by_dtype()
        print(f"main: bf16 forward B={b_} T={t_}: kernel launches "
              f"{counts}", flush=True)
        want = 66 if entry == "mh_flash_attention" else 50
        got = {k: v["bfloat16"] for k, v in counts.items()}
        if got[entry] != want or sum(got.values()) != want or any(
                v["float32"] for v in counts.values()):
            fail(f"bf16 forward B={b_} T={t_} launched {counts}, expected "
                 f"{entry} {want} times in bfloat16 and nothing else")
        bf16[entry] = got[entry]
        del feats, lens
    by_dtype["bfloat16"] = bf16

    t1 = time.perf_counter()
    for _ in range(iters):
        bench_forward()
    fwd_s = (time.perf_counter() - t1) / iters
    fwd_rate = 16 * 60.0 / fwd_s
    print(f"speed: bench.py offline shape bf16 (B=16, T={t_b}): "
          f"{fwd_s * 1e3:.1f} ms/forward, {fwd_rate:.1f} audio-s/s on "
          f"{card}", flush=True)
    # phase 6: where the device time goes in the bf16 forward
    device_profile(bench_forward, "bench.py shape bf16 forward")
    return by_dtype, {"recognize_batch_fp32_audio_s_per_s": rec_rate,
                      "bench_forward_bf16_audio_s_per_s": fwd_rate,
                      "cpu_logits_max_abs_err": cpu_err,
                      "cpu_feats_max_abs_err": cpu_feat_err,
                      "cpu_logits_limit": limit,
                      "tf32_control_logits_max_abs_err": tf32_err,
                      "tf32_control_feats_max_abs_err": tf32_feat_err}

# ---------------------------------------------------------------------------
# phase 7: the 2pass session
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def wrapped(obj, name: str, around):
    """obj.name replaced by around(original) inside the block."""
    own = name in vars(obj)
    orig = getattr(obj, name)
    setattr(obj, name, around(orig))
    try:
        yield
    finally:
        if own:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)


def after(sink):
    """For `wrapped`: a wrapper that hands each result to sink."""
    def around(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            sink(out)
            return out
        return call
    return around


def vad_events(events: list, ms: list = None):
    """For `wrapped` on FsmnVadStream.accept: collect its events and, if
    given, its host ms."""
    def around(fn):
        def call(samples, is_final=False):
            t1 = time.perf_counter()
            ev = fn(samples, is_final)
            if ms is not None:
                ms.append((time.perf_counter() - t1) * 1e3)
            events.extend(ev)
            return ev
        return call
    return around


def two_pass_audio():
    """The bursts between digital silence, and each burst's [start, end)
    in ms."""
    import numpy as np

    parts, spans, at = [], [], 0
    for k, (sil, sec) in enumerate(BURSTS):
        parts += [np.zeros(int(sil * FS), np.float32),
                  synth_audio(sec, 200 + k)]
        at += int(sil * FS)
        spans.append((at * 1000 // FS, (at + int(sec * FS)) * 1000 // FS))
        at += int(sec * FS)
    parts.append(np.zeros(int(TAIL_SILENCE * FS), np.float32))
    return np.concatenate(parts), spans


def feed_all(sess, wave):
    """The wave in MESSAGE-sample messages, the last one final: the
    results and each feed()'s host time (s)."""
    out, secs = [], []
    for a in range(0, len(wave), MESSAGE):
        t0 = time.perf_counter()
        out.append(sess.feed(wave[a: a + MESSAGE],
                             is_final=a + MESSAGE >= len(wave)))
        secs.append(time.perf_counter() - t0)
    return out, secs


def closed_segments(events):
    """Online VAD events ([s,-1], [-1,e], [s,e]) -> closed [s, e]."""
    out, start = [], -1
    for s, e in events:
        if s != -1:
            start = s
        if e != -1 and start != -1:
            out.append([start, e])
            start = -1
    return out


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def save_2pass_dirs(tmp: str, gen):
    """Phase 7's dirs in tmp, weights drawn from gen: paraformer_large_online
    (`online`), the FSMN VAD (`vad`) and the punctuation model (`punc`).
    Returns their configurations."""
    import dataclasses

    import numpy as np
    import torch

    from asr2pass_tpu_torch.config import (PuncConfig,
                                           paraformer_large_online,
                                           vad_default)
    from asr2pass_tpu_torch.models import ct_transformer, fsmn_vad, paraformer
    from asr2pass_tpu_torch.runtime import model_zoo

    online_cfg = paraformer_large_online()
    tokens = ["<blank>", "<s>", "</s>", "<unk>"] + [
        chr(0x4E00 + i) for i in range(online_cfg.vocab_size - 4)]
    d = online_cfg.frontend.lfr_dim
    cmvn = (np.full(d, -12.0, np.float32), np.full(d, 0.25, np.float32))
    online_dir = os.path.join(tmp, "online")
    model_zoo.save_offline_bundle(
        online_dir, paraformer.init(online_cfg, gen, "cuda"), online_cfg,
        tokens, cmvn)
    # The VAD's weights are random, so the phase makes the segmentation
    # follow the signal in both of the ways the reference's options allow:
    # decibel_thres puts the energy gate between silence and the bursts,
    # and the out2 bias of the silence pdf is seeded at -20, so the net
    # never calls a frame silence and the energy gate alone decides
    vad_cfg = dataclasses.replace(vad_default(),
                                  decibel_thres=VAD_DECIBEL_THRES)
    vad_model = fsmn_vad.init(vad_cfg, gen, "cuda")
    with torch.no_grad():
        vad_model.out2.b[list(vad_cfg.sil_pdf_ids)] = -20.0
    vad_dir = os.path.join(tmp, "vad")
    vad_cmvn = (np.full(400, -12.0, np.float32),
                np.full(400, 0.25, np.float32))
    model_zoo.save_vad_dir(vad_dir, vad_model, vad_cfg, vad_cmvn)
    del vad_model
    punc_cfg = PuncConfig()
    punc_tokens = ["<blank>", "<unk>"] + tokens[4:]
    punc_tokens += [f"w{i}" for i in range(punc_cfg.vocab_size
                                           - len(punc_tokens))]
    punc_dir = os.path.join(tmp, "punc")
    model_zoo.save_punc_dir(punc_dir, ct_transformer.init(punc_cfg, gen),
                            punc_cfg, punc_tokens)

    return online_cfg, vad_cfg, punc_cfg


def two_pass_phase(model_dir: str, tmp: str, gen, card: str):
    """Phase 7. Returns the 2pass run's launches by dtype and entry point,
    and its printed numbers."""
    import dataclasses

    import numpy as np
    import torch

    from asr2pass_tpu_torch.models import (ct_transformer, fsmn_vad,
                                           paraformer, paraformer_online,
                                           sanm_decoder)
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime import model_zoo
    from asr2pass_tpu_torch.runtime.asr_stream import ParaformerOnlineStream
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.punc import Punctuator
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession
    from asr2pass_tpu_torch.runtime.vad_stream import (FsmnVadStream,
                                                       vad_options)
    from asr2pass_tpu_torch.vad.e2e_vad import E2EVadStateMachine

    t0 = time.perf_counter()
    # the four models at full width, each saved as a model dir and loaded
    # back through the loaders; pass 2 reuses phase 3's dir
    with CLOCK.part("build"):
        online_cfg, vad_cfg, punc_cfg = save_2pass_dirs(tmp, gen)
        d = online_cfg.frontend.lfr_dim
        online_dir, vad_dir, punc_dir = (os.path.join(tmp, k)
                                         for k in ("online", "vad", "punc"))
        on_b = model_zoo.load_offline_bundle(online_dir)
        off_b = model_zoo.load_offline_bundle(model_dir)
        vad_sd, vad_cfg2, vad_cmvn2 = model_zoo.load_vad_dir(vad_dir)
        punc_sd, punc_cfg2, punc_tok = model_zoo.load_punc_dir(punc_dir)
        if (dataclasses.asdict(vad_cfg2) != dataclasses.asdict(vad_cfg)
                or dataclasses.asdict(punc_cfg2)
                != dataclasses.asdict(punc_cfg)):
            fail("2pass: a model dir does not load back its configuration")
        vad = FsmnVadStream(vad_sd, vad_cfg2, cmvn=vad_cmvn2)
        online = ParaformerOnlineStream(on_b.params, on_b.cfg, on_b.vocab,
                                        cmvn=on_b.cmvn)
        offline = ParaformerOffline(off_b.params, off_b.cfg, off_b.vocab,
                                    cmvn=off_b.cmvn)
        punc = Punctuator(punc_sd, punc_cfg2, punc_tok)
    n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in
                (("pass 1", online.params), ("pass 2", offline.model),
                 ("vad", vad.params), ("punc", punc.params))}
    print(f"2pass: models {n_params}, init+save+load "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    wave, spans = two_pass_audio()
    audio_s = len(wave) / FS
    rec = {"vad_ms": [], "events": [], "p1_ms": [], "p1_inputs": [],
           "punc_ms": [], "segments": [], "t_lfr": [], "finite": [],
           "sm_calls": []}

    def timed(key, fn):
        def call(*a, **kw):
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            rec[key].append((time.perf_counter() - t1) * 1e3)
            return out
        return call

    def run_chunk(fn):
        def call(feats, is_final):
            if len(rec["p1_inputs"]) < 10:
                rec["p1_inputs"].append((online.state, feats.copy(),
                                         is_final))
            return timed("p1_ms", fn)(feats, is_final)
        return call

    def finite(*xs):
        rec["finite"].extend(torch.isfinite(x).all() for x in xs)

    def automaton_input(fn):
        # the session's automaton calls: posteriors, waveform chunk, flags
        def call(sm, scores, waveform, **kw):
            if sm is vad.sm:
                rec["sm_calls"].append((np.array(scores, np.float32),
                                        np.array(waveform, np.float32),
                                        dict(kw)))
            return fn(sm, scores, waveform, **kw)
        return call

    def forward(fn):
        def call(feats, lengths, *a):
            out = fn(feats, lengths, *a)
            rec["t_lfr"].append(max(lengths))
            finite(out.logits, out.us_alphas, out.us_cif_peak)
            return out
        return call

    def finalize(fn):
        def call(frame):
            out = fn(frame)
            rec["segments"].append((frame.global_start, frame.global_end,
                                    len(frame.data), out))
            return out
        return call

    sess = TwoPassSession(vad, online, offline, punc=punc, mode="2pass")
    torch.cuda.synchronize()
    att.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for obj, name, around in (
                (vad, "accept", vad_events(rec["events"], rec["vad_ms"])),
                (online, "_run_chunk", run_chunk),
                (offline, "_forward", forward),
                (punc, "add_punc_streaming",
                 lambda fn: timed("punc_ms", fn)),
                (sess, "_finalize_segment", finalize),
                (sanm_decoder, "apply_streaming",
                 after(lambda o: finite(o[0]))),
                (fsmn_vad, "apply", after(lambda o: finite(o[0]))),
                (ct_transformer, "apply", after(finite)),
                (E2EVadStateMachine, "__call__", automaton_input)):
            stack.enter_context(wrapped(obj, name, around))
        nb.reset_call_counts()
        results, secs = feed_all(sess, wave)
        vad_calls = nb.call_counts()["vad_chunk"]
    torch.cuda.synchronize()
    launches = att.launch_counts_by_dtype()
    print(f"2pass: session run ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # -- gates ----------------------------------------------------------
    if not bool(torch.stack([f.cpu() for f in rec["finite"]]).all()):
        fail("2pass: non-finite logits or posteriors")
    segs = closed_segments(rec["events"])
    print(f"2pass: VAD events {rec['events']}; bursts {spans}", flush=True)
    if len(segs) != len(spans):
        fail(f"2pass: {len(segs)} closed VAD segments for {len(spans)} "
             "bursts")
    # the VAD puts a start (window - sil_to_speech threshold + lookback)
    # = 250 ms before the onset it detects, by design
    lead = (vad_cfg.window_size_ms - vad_cfg.sil_to_speech_time_thres
            + vad_cfg.lookback_time_start_point)
    nxt = [b0 for b0, _ in spans[1:]] + [int(audio_s * 1000)]
    for (s, e), (b0, b1), n0 in zip(segs, spans, nxt):
        if not (abs(s - (b0 - lead)) <= VAD_START_TOL_MS and b0 < e <= n0):
            fail(f"2pass: VAD segment [{s}, {e}] does not match the burst "
                 f"[{b0}, {b1}] (start expected at {b0 - lead} +- "
                 f"{VAD_START_TOL_MS} ms)")
    partials = "".join(r.partial for r in results)
    if not partials:
        fail("2pass: no pass-1 partial text")
    fcfg = off_b.cfg.frontend
    if [[g0, g1] for g0, g1, _, _ in rec["segments"]] != segs:
        fail(f"2pass: pass-2 segments {rec['segments']} are not the VAD's")
    for g0, g1, n, out in rec["segments"]:
        n_mel = 1 + (n - fcfg.frame_length) // fcfg.frame_shift
        end = g0 + -(-n_mel // fcfg.lfr_n) * fcfg.lfr_n * fcfg.frame_shift_ms
        if not out["text"]:
            fail(f"2pass: empty final for the segment [{g0}, {g1}]")
        if not out["stamps"] or any(not g0 <= b <= e <= end
                                    for b, e in out["stamps"]):
            fail(f"2pass: timestamps outside the segment [{g0}, {g1}]")
    if len(rec["punc_ms"]) != len(segs):
        fail(f"2pass: {len(rec['punc_ms'])} punctuation calls for "
             f"{len(segs)} finals")
    n256 = sum(128 < t <= 256 for t in rec["t_lfr"])
    want = 50 * n256
    got = launches["mh_flash_attention"]["float32"]
    others = sum(n for name, by in launches.items()
                 for dt, n in by.items()
                 if (name, dt) != ("mh_flash_attention", "float32"))
    print(f"2pass: pass-2 T_lfr {rec['t_lfr']}; kernel launches {launches}",
          flush=True)
    if n256 < 1 or got != want or others:
        fail(f"2pass: launched {launches}, expected mh_flash_attention "
             f"{want} times in float32 (50 x {n256} bucket-256 segments) "
             "and nothing else")

    # card vs CPU. VAD: a session on the CPU with the same VAD (the ASR
    # passes do not feed the VAD, so they are left out) gives the same
    # events from the same messages
    cpu_events = []
    with CLOCK.part("cpu"):
        vad_cpu = FsmnVadStream(vad_sd, vad_cfg2, cmvn=vad_cmvn2,
                                device="cpu")
        with wrapped(vad_cpu, "accept", vad_events(cpu_events)):
            feed_all(TwoPassSession(vad_cpu, None, None, mode="2pass"),
                     wave)
    if cpu_events != rec["events"]:
        fail(f"2pass: the CPU's VAD events {cpu_events} differ")
    # the session's automaton ran natively, one call a message; its
    # input replayed through the native and the plain automaton
    if vad_calls != len(rec["sm_calls"]) or not vad_calls:
        fail(f"2pass: {vad_calls} native automaton calls for "
             f"{len(rec['sm_calls'])} automaton steps")
    with CLOCK.part("cpu"):
        automaton = automaton_gate(rec["sm_calls"], vad_options(vad_cfg2),
                                   rec["events"], card)
    t_vad = time.perf_counter() - t0
    # pass 1: the first 10 chunks' steps from the card's state, copied to
    # the CPU, on both devices
    with CLOCK.part("cpu"):
        cpu_online = paraformer.from_state_dict(on_b.params, on_b.cfg,
                                                "cpu")
    center = on_b.cfg.chunk_size[1]
    p1_err, p1_limit = 0.0, 0.0
    for st, feats, fin in rec["p1_inputs"]:
        padded = np.zeros((1, center, d), np.float32)
        padded[0, :len(feats)] = feats
        outs = []
        for dev, model in (("cpu", cpu_online), ("cuda", online.params)):
            logits = []
            with CLOCK.part(on_cpu(dev)), wrapped(
                    sanm_decoder, "apply_streaming",
                    after(lambda o: logits.append(o[0]))):
                _, _, n = paraformer_online.step(
                    model, on_b.cfg,
                    paraformer_online.OnlineState(*(x.to(dev) for x in st)),
                    torch.from_numpy(padded).to(dev),
                    torch.tensor([len(feats)], dtype=torch.int32,
                                 device=dev),
                    torch.tensor([fin], device=dev))
            outs.append((int(n[0]), logits[0].cpu()))
        (n_c, l_c), (n_g, l_g) = outs
        limit = CPU_TOL * max(1.0, l_c.abs().max().item())
        err = (l_g - l_c).abs().max().item() if n_g == n_c else float("inf")
        if not err <= limit:
            fail(f"2pass: pass-1 step card vs cpu: counts {n_g}/{n_c}, "
                 f"max |logits| err {err:.3e} (limit {limit:.3e})")
        p1_err, p1_limit = max(p1_err, err), max(p1_limit, limit)
    del cpu_online
    t_p1 = time.perf_counter() - t0
    # pass 2: the first segment's front-end and forward on both devices
    seg_audio = wave[segs[0][0] * FS // 1000: segs[0][1] * FS // 1000]
    n_mel = 1 + (len(seg_audio) - fcfg.frame_length) // fcfg.frame_shift
    t_lfr = -(-n_mel // fcfg.lfr_n)
    with CLOCK.part("cpu"):
        cpu_off = ParaformerOffline(off_b.params, off_b.cfg, off_b.vocab,
                                    cmvn=off_b.cmvn, device="cpu")
    outs = []
    for dev, asr in (("cpu", cpu_off), ("cuda", offline)):
        with CLOCK.part(on_cpu(dev)):
            feats = offline_frontend_device([seg_audio], [n_mel], 256,
                                            fcfg, *off_b.cmvn, batch_b=1,
                                            device=dev)
            with torch.inference_mode():
                out = asr._forward(feats, [t_lfr])
            outs.append((int(out.token_num[0]), out.logits[0].cpu()))
    del cpu_off
    (n_c, l_c), (n_g, l_g) = outs
    p2_limit = CPU_TOL * max(1.0, l_c[:n_c].abs().max().item())
    p2_err = ((l_g[:n_c] - l_c[:n_c]).abs().max().item() if n_g == n_c
              else float("inf"))
    print(f"2pass: card vs cpu (done at {t_vad:.1f} / {t_p1:.1f} / "
          f"{time.perf_counter() - t0:.1f} s): VAD events equal "
          f"({len(cpu_events)}); "
          f"pass 1, {len(rec['p1_inputs'])} chunks: max |logits| err "
          f"{p1_err:.3e} (limit {p1_limit:.3e}); pass 2, T={t_lfr}: "
          f"token_num {n_g}/{n_c}, max |logits| err {p2_err:.3e} (limit "
          f"{p2_limit:.3e})", flush=True)
    if not p2_err <= p2_limit:
        fail(f"2pass: pass-2 card vs cpu logits differ by {p2_err:.3e}")

    # -- numbers ----------------------------------------------------------
    final_secs = [secs[i] * 1e3 for i, r in enumerate(results)
                  if r.final_text]
    n_punc = sum(out["text"].count(p) for *_, out in rec["segments"]
                 for p in "，。？、")
    numbers = {
        "audio_s": audio_s, "messages": len(secs),
        "rtf": sum(secs) / audio_s,
        "pass1_step_ms_p50": _pct(rec["p1_ms"], 50),
        "pass1_step_ms_p95": _pct(rec["p1_ms"], 95),
        "pass1_chunks": len(rec["p1_ms"]),
        "pass2_final_feed_ms": final_secs,
        "vad_ms_per_message_p50": _pct(rec["vad_ms"], 50),
        "vad_ms_per_message_p95": _pct(rec["vad_ms"], 95),
        "punc_ms_per_final": rec["punc_ms"],
        "feed_ms_p50": _pct([x * 1e3 for x in secs], 50),
        "final_chars": [len(out["text"]) for *_, out in rec["segments"]],
        "punctuation_marks": n_punc, "partial_chars": len(partials),
        "pass1_logits_max_abs_err": p1_err, "pass1_logits_limit": p1_limit,
        "pass2_logits_max_abs_err": p2_err, "pass2_logits_limit": p2_limit,
    }
    print(f"2pass: {json.dumps(numbers)}", flush=True)
    numbers["automaton"] = automaton

    # the batched pass-1 step: ms a step of B streams (10 steps each, one
    # chunk of `center` frames per stream), and the streams whose 600 ms
    # chunks one card keeps up with at that B
    for b in (1, 16, 64):
        state = paraformer_online.init_state(online.params, on_b.cfg, b)
        feats = torch.randn(b, center, d, generator=gen, device="cuda")
        cnt = torch.full((b,), center, dtype=torch.int32, device="cuda")
        fin = torch.zeros(b, dtype=torch.bool, device="cuda")
        for _ in range(2):
            state, _, n = paraformer_online.step(online.params, on_b.cfg,
                                                 state, feats, cnt, fin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(10):
            state, _, n = paraformer_online.step(online.params, on_b.cfg,
                                                 state, feats, cnt, fin)
        n.cpu()
        ms = (time.perf_counter() - t1) * 1e3 / 10
        numbers[f"pass1_step_B{b}_ms"] = ms
        print(f"2pass: batched pass-1 step B={b}: {ms:.1f} ms/step, "
              f"{b * int(600 // ms)} streams a card within the 600 ms "
              f"chunk on {card}", flush=True)

    # one traced run of the session's first PROFILE_MESSAGES messages (one
    # pass-2 final among them), the device alone
    sess = TwoPassSession(vad, online, offline, punc=punc, mode="2pass")
    sess.reset()
    prof = device_profile(
        lambda: feed_all(sess, wave[: PROFILE_MESSAGES * MESSAGE]),
        f"2pass session, first {PROFILE_MESSAGES} messages",
        host_ops=False)
    if prof.get("launches"):
        print(f"profile: 2pass session: "
              f"{prof['launches'] / PROFILE_MESSAGES:.0f} launches a 600 ms "
              f"message", flush=True)
    print(f"2pass: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 8: the websocket server with the batched StreamEngine
# ---------------------------------------------------------------------------

def s16_bytes(wave) -> bytes:
    import numpy as np

    return np.clip(np.round(wave * 32768.0), -32768, 32767).astype(
        "<i2").tobytes()


def wav_bytes(wave, fs: int) -> bytes:
    """A mono 16-bit WAV file of the wave at fs."""
    import io
    import wave as wavefile

    buf = io.BytesIO()
    with wavefile.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(s16_bytes(wave))
    return buf.getvalue()


def burst_stream(seed: int, n_bursts: int, total_s: float = None,
                 lead_s: float = 0.0):
    """Seeded client audio as phase 7 draws it: n_bursts speech-like
    bursts of 9.5-13.5 s, each after 2-4 s of digital silence, then a
    silent tail (2 s, or up to total_s); lead_s more seconds of silence
    first. Returns (s16le bytes, burst spans in ms)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    at = int(lead_s * FS)
    parts, spans = [np.zeros(at, np.float32)], []
    for k in range(n_bursts):
        sil, sec = rng.uniform(2.0, 4.0), rng.uniform(9.5, 13.5)
        parts += [np.zeros(int(sil * FS), np.float32),
                  synth_audio(sec, seed * 10 + k)]
        at += int(sil * FS)
        spans.append((at * 1000 // FS, (at + int(sec * FS)) * 1000 // FS))
        at += int(sec * FS)
    tail = 2.0 if total_s is None else max(2.0, total_s - at / FS)
    parts.append(np.zeros(int(tail * FS), np.float32))
    return s16_bytes(np.concatenate(parts)), spans


def p8a_stream(seed: int, wrap: bool, ring: int):
    """An 8a connection: burst_stream's P8A_BURSTS bursts; with wrap, led
    by the silence that ends its last burst 1 s past the engine's audio
    ring (`ring` samples), so that segment's ring gather wraps."""
    data, spans = burst_stream(seed, P8A_BURSTS)
    if not wrap:
        return data, spans
    lead = max(0.0, ring / FS + 1.0 - spans[-1][1] / 1000)
    return burst_stream(seed, P8A_BURSTS, lead_s=lead)


async def ws_client(port: int, name: str, data: bytes, mode: str,
                    pace: float = None, delay: float = 0.0,
                    first: str = None):
    """The reference client's sequence for one connection: first message
    (`first`, or reference_first_message's), 9600-sample frames (every
    `pace` s after `delay`, or as fast as the server takes them),
    {"is_speaking": false}; messages are read as they come until the
    final. Returns (frame send times, [(recv time, msg)])."""
    import asyncio

    import websockets

    stride = 2 * MESSAGE
    frames = [data[i: i + stride] for i in range(0, len(data), stride)]
    sends, msgs = [], []
    async with websockets.connect(f"ws://127.0.0.1:{port}",
                                  max_size=1 << 30) as ws:
        await ws.send(first or reference_first_message(mode, name))

        async def reader():
            while True:
                m = json.loads(await ws.recv())
                msgs.append((time.perf_counter(), m))
                if m.get("is_final"):
                    return

        task = asyncio.create_task(reader())
        await asyncio.sleep(delay)
        t0 = time.perf_counter()
        for k, f in enumerate(frames):
            if pace:
                await asyncio.sleep(max(0.0, t0 + k * pace
                                        - time.perf_counter()))
            await ws.send(f)
            sends.append(time.perf_counter())
        await ws.send(json.dumps({"is_speaking": False}))
        await asyncio.wait_for(task, timeout=600)
    return sends, msgs


def check_stream(name, msgs, spans, segs, fcfg, stamps: bool = True):
    """Phase 8's per-connection gates: exactly one is_final, the last
    message; one non-empty 2pass-offline result per burst, with timestamp
    and stamp_sents in the reference schema and its times inside its VAD
    segment (stamps=False: a pass 2 without timestamps, SenseVoice's,
    must send none); non-empty 2pass-online partials."""
    ms = [m for _, m in msgs]
    finals = [i for i, m in enumerate(ms) if m.get("is_final")]
    if finals != [len(ms) - 1] or any(m["wav_name"] != name for m in ms):
        fail(f"server: {name}: finals at {finals} of {len(ms)} messages")
    offs = [m for m in ms if m["mode"] == "2pass-offline"]
    if len(offs) != len(spans) or len(segs) != len(spans):
        fail(f"server: {name}: {len(offs)} pass-2 results and {len(segs)} "
             f"segments for {len(spans)} bursts")
    for m, (g0, _g1, n) in zip(offs, segs):
        if not stamps:
            if not m["text"] or "timestamp" in m:
                fail(f"server: {name}: pass-2 result {m}")
            continue
        n_mel = 1 + (n - fcfg.frame_length) // fcfg.frame_shift
        end = g0 + -(-n_mel // fcfg.lfr_n) * fcfg.lfr_n * fcfg.frame_shift_ms
        stamps = json.loads(m.get("timestamp", "[]"))
        sents = m.get("stamp_sents")
        if (not m["text"] or not stamps or not isinstance(sents, list)
                or any(set(r) != {"text_seg", "punc", "start", "end",
                                  "ts_list"} for r in sents)
                or any(not (isinstance(b, int) and isinstance(e, int)
                            and g0 <= b <= e <= end) for b, e in stamps)):
            fail(f"server: {name}: pass-2 result {m} outside its segment "
                 f"[{g0}, {end}] or not in the reference schema")
    if not any(m["mode"] == "2pass-online" and m["text"] for m in ms):
        fail(f"server: {name}: no 2pass-online partial")


def server_latencies(sends, msgs, spans):
    """(partial ms, final ms) of one paced connection: each frame inside a
    burst to the next 2pass-online result; the frame that carries a
    burst's end plus the VAD's tail silence to that burst's 2pass-offline
    result."""
    part = [t for t, m in msgs if m["mode"] == "2pass-online"]
    fin = [t for t, m in msgs if m["mode"] == "2pass-offline"]
    step_ms = MESSAGE * 1000 // FS
    partial = []
    for k, t in enumerate(sends):
        if any(b0 <= k * step_ms and (k + 1) * step_ms <= b1
               for b0, b1 in spans):
            nxt = [r for r in part if r > t]
            if nxt:
                partial.append((nxt[0] - t) * 1e3)
    final = []
    for (_, b1), t_res in zip(spans, fin):
        k = min((b1 + VAD_TAIL_SIL_MS) // step_ms, len(sends) - 1)
        final.append((t_res - sends[k]) * 1e3)
    return partial, final


def engine_card_vs_cpu(models):
    """One tick of the fused VAD step and of the fused pass-1 step at
    capacity 4, full width, on the card and on the CPU with the same
    inputs: silence posteriors and pass-1 logits within CPU_TOL of their
    range, ids and counts equal, the int16 ring bit-equal."""
    import numpy as np
    import torch

    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.models import (fsmn_vad, paraformer,
                                           paraformer_online, sanm_decoder)
    from asr2pass_tpu_torch.runtime import engine as eng_mod

    cap, ring = 4, eng_mod._RING_SAMPLES
    vcfg, ocfg = models.vad_cfg, models.online_cfg or models.asr_cfg
    oparams = (models.online_params if models.online_params is not None
               else models.asr_params)
    cpu = torch.device("cpu")
    waves = np.stack([np.round(synth_audio(MESSAGE / FS, 300 + i) * 32767)
                      .astype(np.int16) for i in range(cap)])
    vf, af = vcfg.frontend, ocfg.frontend
    nf = num_frames(MESSAGE, vf)
    left = (vf.lfr_m - 1) // 2
    k_vad = (nf - 1 - (vf.lfr_m - 1) + left) // vf.lfr_n + 1
    # rows: n_new, win_start, total_new, k_emit, finals, ring_off, n_samp,
    # win_off (a fresh slot's first 600 ms message)
    vad_ints = np.zeros((8, cap), np.int64)
    vad_ints[0], vad_ints[2], vad_ints[3], vad_ints[6] = nf, nf, k_vad, MESSAGE
    na = num_frames(MESSAGE, af)
    k_p1 = (na - 1 - (af.lfr_m - 1) + (af.lfr_m - 1) // 2) // af.lfr_n + 1
    center = ocfg.chunk_size[1]
    # rows: start_off, n_new, win_start, total_new, k_emit, fe_finals,
    # ring_woff, consume_start, consume_count, finals
    p1_ints = np.zeros((10, cap), np.int64)
    p1_ints[1], p1_ints[3], p1_ints[4] = na, na, k_p1
    p1_ints[8] = min(k_p1, center)
    out = []
    for dev in (cpu, torch.device("cuda")):
        with CLOCK.part(on_cpu(dev)):
            if dev.type == "cpu":
                vad = fsmn_vad.from_state_dict(
                    {k: v.cpu() for k, v in models.vad_params.state_dict()
                     .items()}, vcfg, "cpu")
                online = paraformer.from_state_dict(
                    {k: v.cpu() for k, v in oparams.state_dict().items()},
                    ocfg, "cpu")
            else:
                vad, online = models.vad_params, oparams
            vstep, _, max_new = eng_mod._fused_vad_step(
                vf, cap, tuple(vcfg.sil_pdf_ids), ring, dev)
            pstep, _, hist_n, ring_n, _ = eng_mod._fused_p1_step(ocfg, cap,
                                                                 ring, dev)
            w = np.zeros((cap, max_new), np.int16)
            w[:, :MESSAGE] = waves
            ones = lambda d_: (torch.zeros(d_, device=dev),
                               torch.ones(d_, device=dev))
            with torch.inference_mode():
                audio = torch.zeros(cap, ring, dtype=torch.int16, device=dev)
                vi = torch.from_numpy(vad_ints).to(dev)
                sil, _, _ = vstep(
                    vad, *ones(vf.lfr_dim), torch.from_numpy(w).to(dev),
                    vi[0], vi[1], vi[2], vi[3], vi[4],
                    torch.zeros(cap, vf.lfr_m - 1, vf.n_mels, device=dev),
                    fsmn_vad.init_caches(vcfg, cap, dev), audio, vi[5], vi[6],
                    vi[7])
                logits = []
                with wrapped(sanm_decoder, "apply_streaming",
                             after(lambda o: logits.append(o[0]))):
                    _, ids, nums, _ = pstep(
                        online, *ones(af.lfr_dim),
                        paraformer_online.init_state(online, ocfg, cap), audio,
                        *torch.from_numpy(p1_ints).to(dev),
                        torch.zeros(cap, hist_n, af.n_mels, device=dev),
                        torch.zeros(cap, ring_n, af.lfr_dim, device=dev))
            out.append((sil[:, :k_vad].cpu(), audio.cpu(), ids.cpu(),
                        nums.cpu(), logits[0].float().cpu()))
    (s_c, r_c, i_c, n_c, l_c), (s_g, r_g, i_g, n_g, l_g) = out
    sil_limit = CPU_TOL * max(1.0, s_c.abs().max().item())
    sil_err = (s_g - s_c).abs().max().item()
    logit_limit = CPU_TOL * max(1.0, l_c.abs().max().item())
    same = torch.equal(n_g, n_c) and all(
        torch.equal(i_g[b, :int(n_c[b])], i_c[b, :int(n_c[b])])
        for b in range(cap))
    logit_err = ((l_g - l_c).abs().max().item() if same else float("inf"))
    print(f"server: card vs cpu, one fused tick at capacity {cap}: silence "
          f"posteriors {sil_err:.3e} (limit {sil_limit:.3e}), ring equal "
          f"{torch.equal(r_g, r_c)}; pass-1 counts {n_g.tolist()} / "
          f"{n_c.tolist()}, logits {logit_err:.3e} (limit "
          f"{logit_limit:.3e})", flush=True)
    if not (sil_err <= sil_limit and torch.equal(r_g, r_c) and same
            and logit_err <= logit_limit and int(n_c.sum()) > 0):
        fail("server: the fused engine steps differ between card and CPU")
    return {"engine_cpu_sil_max_abs_err": sil_err,
            "engine_cpu_logits_max_abs_err": logit_err}


def server_phase(model_dir: str, tmp: str, card: str):
    """Phase 8: the port's websocket server with the batched engine,
    launched through the launcher's build_models on the phase-3 and
    phase-7 model dirs, driven by the reference client's messages.
    Returns (engine-run launches by entry point and dtype, the pass-2
    forward shapes, printed numbers)."""
    import asyncio

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from asr2pass_tpu_torch.frontend.audio import (linear_resample,
                                                   load_pcm_bytes,
                                                   load_wav_bytes)
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
    from asr2pass_tpu_torch.runtime.two_pass import TwoPassSession
    from asr2pass_tpu_torch.runtime.vad_stream import FsmnVadStream
    from asr2pass_tpu_torch.server.run_server import build_models, parser
    from asr2pass_tpu_torch.server.ws_server import AsrWsServer
    from asr2pass_tpu_torch.text.itn import ChineseITN

    t0 = time.perf_counter()
    args = parser().parse_args([
        "--model-dir", model_dir,
        "--online-model-dir", os.path.join(tmp, "online"),
        "--vad-dir", os.path.join(tmp, "vad"),
        "--punc-dir", os.path.join(tmp, "punc"),
        "--engine", "--engine-capacity", str(ENGINE_CAPACITY),
        "--host", "127.0.0.1", "--port", "0"])
    with CLOCK.part("build"):
        models = build_models(args)
    if not isinstance(models.itn, ChineseITN) or models.device.type != "cuda":
        fail("server: build_models did not give ITN models on the card")
    fcfg = models.asr_cfg.frontend
    rec = {"ticks": [], "segs": {}, "lane": [], "fwd": [], "vad": [],
           "wraps": 0}
    numbers = {"card": card}

    async def main():
        server = AsrWsServer(
            models, host=args.host, port=args.port,
            decode_workers=args.decode_workers, use_engine=args.engine,
            engine_capacity=args.engine_capacity,
            upload_overlap=args.upload_overlap,
            decide_async=args.decide_async,
            max_message_bytes=args.max_message_mb << 20,
            max_upload_bytes=args.max_upload_mb << 20)
        srv = await server.serve()
        port = srv.sockets[0].getsockname()[1]
        eng = server.engine
        print(f"server: models loaded, engine capacity {eng.capacity} "
              f"warmed, listening ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        def conn_name(sid, slot):
            conn = server._engine_conns.get(sid)
            return (conn[1].wav_name if conn is not None
                    and eng.slots[sid] is slot else None)

        step = eng.step

        def timed_step():
            t1 = time.perf_counter()
            step()
            rec["ticks"].append(time.perf_counter() - t1)

        process = eng._process_segments

        def logged_segments(pairs, settled=None):
            rec["lane"].append(len(pairs))
            for sid, slot, fr in pairs:
                rec["segs"].setdefault(conn_name(sid, slot), []).append(
                    (fr.global_start, fr.global_end, len(fr.data)))
                # a segment across the audio ring's end: its gather wraps
                rec["wraps"] += (fr.samp_start // eng._ring_samples
                                 != (fr.samp_end - 1) // eng._ring_samples)
            return process(pairs, settled)

        forward = eng.offline.asr._forward

        def logged_forward(feats, lengths, *a):
            rec["fwd"].append(tuple(feats.shape[:2]))
            return forward(feats, lengths, *a)

        reset = eng._reset_slot

        def recording_reset(sid):
            # connection c0's automaton input and events, for the session
            # comparison below
            reset(sid)
            slot = eng.slots[sid]
            sm, name = slot.sm, []

            def call(scores, samples, is_final=False, **kw):
                ev = sm(scores, samples, is_final=is_final, **kw)
                if not name:
                    name.append(conn_name(sid, slot))
                if name[0] == "c0":
                    rec["vad"].append((samples.copy(), is_final, ev))
                return ev

            call.close = sm.close   # the engine frees what it made
            slot.sm = call

        def print_stages(part):
            st = {k: [v["p50_ms"], v["p95_ms"], v["count"]]
                  for k, v in METRICS.report()["stages"].items()}
            numbers[f"stages_{part.split()[0]}"] = st
            print(f"server: {part} stages (p50, p95 ms, count) "
                  f"{json.dumps(st)}", flush=True)

        eng.step, eng._process_segments = timed_step, logged_segments
        eng.offline.asr._forward, eng._reset_slot = (logged_forward,
                                                     recording_reset)
        try:
            # -- 8a: 64 paced connections ----------------------------------
            streams = [p8a_stream(1000 + i, i % P8A_WRAP_EVERY == 0,
                                  eng._ring_samples)
                       for i in range(PACED_CONNECTIONS)]
            rec["wraps"] = 0
            METRICS.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            att.reset_launch_counts()
            nb.reset_call_counts()
            prof = profile(activities=[ProfilerActivity.CUDA])
            trace = {}

            async def traced_window():
                await asyncio.sleep(TRACE_AT_S)
                n0 = len(rec["ticks"])
                prof.start()
                trace["t"] = time.perf_counter()
                deadline = time.perf_counter() + 60
                while (len(rec["ticks"]) < n0 + TRACE_TICKS
                       and time.perf_counter() < deadline):
                    await asyncio.sleep(0.01)
                trace["wall_ms"] = (time.perf_counter() - trace["t"]) * 1e3
                trace["ticks"] = len(rec["ticks"]) - n0
                prof.stop()

            t1 = time.perf_counter()
            tracer = asyncio.create_task(traced_window())
            paced = await asyncio.gather(*[
                ws_client(port, f"c{i}", data, "2pass", PACE_S,
                          i * PACE_S / PACED_CONNECTIONS)
                for i, (data, _) in enumerate(streams)])
            await tracer
            numbers["paced_wall_s"] = time.perf_counter() - t1
            launches = att.launch_counts_by_dtype()
            native_calls = nb.call_counts()
            numbers["paced_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                             / 2 ** 30)
            ticks_a = list(rec["ticks"])
            fwd_a = list(rec["fwd"])
            lane_a = list(rec["lane"])
            numbers["ring_wraps_8a"] = rec["wraps"]
            if not rec["wraps"]:
                fail("server: 8a: no pass-2 segment crossed the audio "
                     "ring's end")
            partial, final = [], []
            for i, ((sends, msgs), (_, spans)) in enumerate(zip(paced,
                                                                streams)):
                check_stream(f"c{i}", msgs, spans, rec["segs"].get(f"c{i}",
                                                                   []), fcfg)
                p, f = server_latencies(sends, msgs, spans)
                partial += p
                final += f
            numbers.update({
                "tick_ms_p50": _pct([x * 1e3 for x in ticks_a], 50),
                "tick_ms_p95": _pct([x * 1e3 for x in ticks_a], 95),
                "ticks": len(ticks_a),
                "partial_ms_p50": _pct(partial, 50),
                "partial_ms_p95": _pct(partial, 95),
                "final_ms_p50": _pct(final, 50),
                "final_ms_p95": _pct(final, 95),
                "pass2_lane_batches": lane_a,
                "pass2_forwards": [list(s) for s in fwd_a],
            })
            print(f"server: 8a, {PACED_CONNECTIONS} paced 2pass "
                  f"connections, {numbers['paced_wall_s']:.1f} s: tick "
                  f"p50/p95 {numbers['tick_ms_p50']:.1f} / "
                  f"{numbers['tick_ms_p95']:.1f} ms over {len(ticks_a)} "
                  f"ticks; partial p50/p95 {numbers['partial_ms_p50']:.1f}"
                  f" / {numbers['partial_ms_p95']:.1f} ms; final p50/p95 "
                  f"{numbers['final_ms_p50']:.1f} / "
                  f"{numbers['final_ms_p95']:.1f} ms; pass-2 lane batches "
                  f"{lane_a}; forwards (B, T) {fwd_a}; segments across "
                  f"the ring's end {rec['wraps']}; peak memory "
                  f"{numbers['paced_peak_mem_gib']:.2f} GiB", flush=True)
            print_stages("8a")
            # every automaton step of 8a ran natively: one call a slot a
            # decided batch
            vd = numbers["stages_8a"].get("vd_automaton")
            numbers["native_calls_8a"] = native_calls
            print(f"native: 8a automaton {native_calls['vad_chunk']} native "
                  f"calls over {len(ticks_a)} ticks "
                  f"({native_calls['vad_chunk'] / len(ticks_a):.1f} a "
                  f"tick); vd_automaton p50/p95 {vd[0]:.3f} / {vd[1]:.3f} "
                  f"ms over {vd[2]} decided batches on {card}", flush=True)
            if not native_calls["vad_chunk"] or native_calls["resample"]:
                fail(f"server: 8a native calls {native_calls}")
            # the engine's VAD against a TwoPassSession's on the card, on
            # the chunks the engine staged for connection c0
            events = [e for _, _, ev in rec["vad"] for e in ev]
            sess_events = []
            vad = FsmnVadStream(models.vad_params, models.vad_cfg,
                                cmvn=models.vad_cmvn,
                                max_end_sil=VAD_TAIL_SIL_MS,
                                max_single_segment=20000)
            with wrapped(vad, "accept", vad_events(sess_events)):
                sess = TwoPassSession(vad, None, None, mode="2pass")
                for samples, fin, _ in rec["vad"]:
                    sess.feed(samples, fin)
            eng_segs = closed_segments(events)
            print(f"server: c0 VAD segments: engine {eng_segs}, "
                  f"TwoPassSession {closed_segments(sess_events)}, bursts "
                  f"{streams[0][1]}", flush=True)
            if eng_segs != closed_segments(sess_events) or not eng_segs:
                fail("server: the engine's VAD segments differ from the "
                     "session's")
            want = sum(50 + (16 if t // 2 + 8 >= 256 else 0)
                       for _, t in fwd_a if t >= 256)
            got = launches["mh_flash_attention"]["float32"]
            others = sum(n for name, by in launches.items()
                         for dt, n in by.items()
                         if (name, dt) != ("mh_flash_attention", "float32"))
            print(f"server: 8a kernel launches {launches} (expected "
                  f"mh_flash_attention fp32 {want})", flush=True)
            if want == 0 or got != want or others:
                fail(f"server: engine run launched {launches}, expected "
                     f"mh_flash_attention {want} times in float32 and "
                     "nothing else")
            if trace.get("ticks"):
                t1 = time.perf_counter()
                kern = [(e.device_time_total, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.device_time_total > 0]
                numbers["trace_read_s"] = time.perf_counter() - t1
                busy = sum(t for t, _ in kern) / 1e3
                n_launch = sum(n for _, n in kern)
                numbers.update({"trace_wall_ms": trace["wall_ms"],
                                "trace_busy_ms": busy,
                                "trace_idle_share": (
                                    1 - busy / trace["wall_ms"]
                                    if busy else None),
                                "trace_launches_per_tick":
                                    n_launch / trace["ticks"]})
                print(f"profile: engine, {trace['ticks']} ticks of 8a: wall "
                      f"{trace['wall_ms']:.1f} ms, device busy "
                      + (f"{busy:.1f} ms, idle share "
                         f"{numbers['trace_idle_share']:.3f}, "
                         if busy else "not measured (no kernel traced), ")
                      + f"{numbers['trace_launches_per_tick']:.0f} launches "
                      f"a tick (pass-2 lane included)", flush=True)

            # -- 8b: 128 unpaced connections -------------------------------
            streams = [burst_stream(2000 + i, 1, UNPACED_SECONDS)
                       for i in range(UNPACED_CONNECTIONS)]
            METRICS.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n_ticks = len(rec["ticks"])
            t1 = time.perf_counter()
            unpaced = await asyncio.gather(*[
                ws_client(port, f"u{i}", data, "2pass")
                for i, (data, _) in enumerate(streams)])
            wall = time.perf_counter() - t1
            audio_s = sum(len(d) / 2 / FS for d, _ in streams)
            for i, ((_, msgs), (_, spans)) in enumerate(zip(unpaced,
                                                            streams)):
                check_stream(f"u{i}", msgs, spans,
                             rec["segs"].get(f"u{i}", []), fcfg)
            numbers.update({
                "unpaced_wall_s": wall, "unpaced_audio_s": audio_s,
                "unpaced_audio_s_per_s": audio_s / wall,
                "unpaced_ticks": len(rec["ticks"]) - n_ticks,
                "unpaced_peak_mem_gib": (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)})
            print(f"server: 8b, {UNPACED_CONNECTIONS} unpaced connections, "
                  f"{audio_s:.1f} s of audio in {wall:.1f} s: "
                  f"{audio_s / wall:.1f} audio-s/s, "
                  f"{min(ENGINE_CAPACITY, audio_s / wall):.0f} real-time "
                  f"streams a card at capacity {ENGINE_CAPACITY}; "
                  f"{numbers['unpaced_ticks']} ticks; peak memory "
                  f"{numbers['unpaced_peak_mem_gib']:.2f} GiB on {card}",
                  flush=True)
            print_stages("8b")

            # -- 8c: one offline upload ------------------------------------
            data = s16_bytes(synth_audio(60.0, 1))
            _, msgs = await ws_client(port, "off", data, "offline")
            ms = [m for _, m in msgs]
            ref = models.create_offline_recognizer(
                vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000).transcribe(
                load_pcm_bytes(data), use_itn=True)
            if (len(ms) != 1 or ms[0]["mode"] != "offline"
                    or ms[0]["is_final"] is not True
                    or not ms[0].get("timestamp")
                    or ms[0]["text"] != ref.text or not ref.text
                    or ms[0]["timestamp"] != json.dumps(ref.timestamps)):
                fail(f"server: 8c offline upload gave {ms}, transcribe "
                     f"gives {ref.text!r}")
            print(f"server: 8c, 60 s offline upload: one final, "
                  f"{len(ms[0]['text'])} chars, "
                  f"{len(json.loads(ms[0]['timestamp']))} stamps, equal to "
                  "OfflineRecognizer.transcribe", flush=True)
            # an 8 kHz WAV upload: the server resamples it to 16 kHz on
            # the native resampler, once
            x8 = linear_resample(synth_audio(UPLOAD_8K_SECONDS, 11), FS,
                                 8000, native=False)
            data = wav_bytes(x8, 8000)
            nb.reset_call_counts()
            _, msgs = await ws_client(
                port, "off8k", data, "offline",
                first=reference_first_message(
                    "offline", "off8k", audio_fs=8000, wav_format="wav"))
            resamples = nb.call_counts()["resample"]
            ms = [m for _, m in msgs]
            ref = models.create_offline_recognizer(
                vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000).transcribe(
                linear_resample(load_wav_bytes(data)[0], 8000, FS),
                use_itn=True)
            print(f"server: 8c, {UPLOAD_8K_SECONDS:.0f} s 8 kHz WAV "
                  f"upload: {resamples} native resample call, "
                  f"{len(ms[0]['text']) if ms else 0} chars, equal to "
                  f"transcribe of linear_resample's 16 kHz samples: "
                  f"{bool(ms) and ms[0]['text'] == ref.text}", flush=True)
            if (resamples != 1 or len(ms) != 1 or not ref.text
                    or ms[0]["mode"] != "offline"
                    or ms[0]["text"] != ref.text):
                fail(f"server: 8c 8 kHz upload gave {ms} after {resamples} "
                     f"native resample calls, transcribe gives "
                     f"{ref.text!r}")

            # -- 8d: one online connection ---------------------------------
            data = s16_bytes(np.concatenate([
                np.zeros(FS, np.float32), synth_audio(ONLINE_SECONDS - 2, 7),
                np.zeros(FS, np.float32)]))
            METRICS.reset()
            _, msgs = await ws_client(port, "on", data, "online", PACE_S)
            ms = [m for _, m in msgs]
            if ({m["mode"] for m in ms} != {"online"}
                    or [m["is_final"] for m in ms].index(True) != len(ms) - 1
                    or not "".join(m["text"] for m in ms)):
                fail(f"server: 8d online stream gave {ms}")
            print(f"server: 8d, {ONLINE_SECONDS:.0f} s online stream: "
                  f"{len(ms) - 1} online partials, "
                  f"{sum(len(m['text']) for m in ms)} chars, then the "
                  "final", flush=True)
            print_stages("8d (one stream, no pass 2)")
        finally:
            server._engine_task.cancel()
            srv.close()
            await srv.wait_closed()
            server.engine.shutdown()
            server.executor.shutdown(wait=False)
            server._offline_executor.shutdown(wait=False)
        return launches, fwd_a

    launches, fwd = asyncio.run(main())
    numbers.update(engine_card_vs_cpu(models))
    print(f"server: {json.dumps(numbers)}", flush=True)
    print(f"server: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, fwd, numbers


# ---------------------------------------------------------------------------
# phase 9: the deployed hotword Paraformer and SenseVoice pass 2
# ---------------------------------------------------------------------------

# latin hotwords; all but the last have a seg_dict entry (two CJK pieces)
LATIN_WORDS = ("hello", "world", "cloud", "speech", "model", "tpu")
HW_SEGMENTS = 16          # 9a: 16 x 15 s, 4 with 5 hotwords, 4 with 20
SVS_TP_BLOCKS = 20        # the tp stack of a converted SenseVoiceSmall
SVS_BEAM = 10
SVS_CONTEXT_WORDS = 5
P9B_BEAM_SECONDS = 30.0   # 9b's longer beam segment against the Python spec
P9_CONNECTIONS = 16       # 9c and 9d: paced connections, PACED_BURSTS each
SVS_LANGS = ("zh", "en", "auto")
HW_TOL = 1e-5             # compiled embeddings card vs CPU (of their range)


def cjk_tokens(vocab_size: int) -> list:
    return ["<blank>", "<s>", "</s>", "<unk>"] + [
        chr(0x4E00 + i) for i in range(vocab_size - 4)]


def hotword_list(n: int, seed: int) -> dict:
    """n hotwords, mixed: CJK words of 2-4 characters, every fourth a
    latin word (through the seg_dict, or <unk> for the last)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = {}
    while len(words) < n:
        if len(words) % 4 == 3:
            w = LATIN_WORDS[len(words) // 4 % len(LATIN_WORDS)]
            w = w if w not in words else f"{w}{len(words)}"
        else:
            w = "".join(chr(0x4E00 + int(k))
                        for k in rng.integers(0, 8000, rng.integers(2, 5)))
        words[w] = 20
    return words


def save_hotword_dir(tmp: str, gen) -> str:
    """9a's dir, `hotword`: paraformer_large(timestamp=True, hotword=True)
    with a converted HotwordConfig() compiler (no null row) and a
    seg_dict, weights drawn from gen on the card."""
    import numpy as np

    from asr2pass_tpu_torch.config import HotwordConfig, paraformer_large
    from asr2pass_tpu_torch.models import hotword, paraformer
    from asr2pass_tpu_torch.runtime import model_zoo

    cfg = paraformer_large(timestamp=True, hotword=True)
    tokens = cjk_tokens(cfg.vocab_size)
    d = cfg.frontend.lfr_dim
    cmvn = (np.full(d, -12.0, np.float32), np.full(d, 0.25, np.float32))
    hw_dir = os.path.join(tmp, "hotword")
    model_zoo.save_offline_bundle(
        hw_dir, paraformer.init(cfg, gen, "cuda"), cfg, tokens, cmvn,
        hotword_params=hotword.init(HotwordConfig(), gen, "cuda",
                                    learned_null=False))
    with open(os.path.join(hw_dir, "seg_dict"), "w", encoding="utf-8") as f:
        for k, w in enumerate(LATIN_WORDS[:-1]):
            f.write(f"{w}\t{tokens[10 + 2 * k]} {tokens[11 + 2 * k]}\n")
    return hw_dir


def save_svs_dir(tmp: str, gen) -> str:
    """9b's dir, `svs`: sensevoice_small() with a SVS_TP_BLOCKS-block tp
    stack, weights drawn from gen on the card."""
    import numpy as np

    from asr2pass_tpu_torch.config import sensevoice_small
    from asr2pass_tpu_torch.models import sensevoice
    from asr2pass_tpu_torch.runtime import model_zoo

    cfg = sensevoice_small()
    d = cfg.frontend.lfr_dim
    cmvn = (np.full(d, -12.0, np.float32), np.full(d, 0.25, np.float32))
    svs_dir = os.path.join(tmp, "svs")
    model_zoo.save_svs_bundle(
        svs_dir, sensevoice.init(cfg, gen, "cuda", tp_blocks=SVS_TP_BLOCKS),
        cfg, cjk_tokens(cfg.vocab_size), cmvn)
    return svs_dir


def hotword_phase(tmp: str, gen, card: str):
    """9a. The deployed hotword model: paraformer_large(timestamp=True,
    hotword=True) with a converted hotword compiler (no null row) and a
    seg_dict, saved as a dir and loaded through build_models. Returns
    (models, parsed args, launches of the 16 x 15 s run, numbers)."""
    import numpy as np
    import torch

    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.models import hotword
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.server.run_server import build_models, parser

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        hw_dir = save_hotword_dir(tmp, gen)
    args = parser().parse_args([
        "--model-dir", hw_dir,
        "--online-model-dir", os.path.join(tmp, "online"),
        "--vad-dir", os.path.join(tmp, "vad"),
        "--punc-dir", os.path.join(tmp, "punc"),
        "--engine", "--engine-capacity", str(ENGINE_CAPACITY),
        "--host", "127.0.0.1", "--port", "0"])
    with CLOCK.part("build"):
        models = build_models(args)
    if (models.hotword_params is None or models.hotword_params.null is not None
            or models.asr_params.decoder.hotword is None
            or models.seg_dict is None or models.device.type != "cuda"):
        fail("hotword: build_models did not wire the dir's hotword compiler, "
             "hotword block and seg_dict on the card")
    print(f"hotword: paraformer_large(timestamp=True, hotword=True) + "
          f"HotwordConfig() compiler, saved and loaded through "
          f"build_models with the online, VAD and punctuation dirs, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    numbers = {"card": card}

    # compiled embeddings, card vs CPU, and the compile's time
    hot20 = hotword_list(20, 1)
    emb20 = models.compile_hotwords(hot20)
    with CLOCK.part("cpu"):
        cpu_hw = hotword.from_state_dict(
            {k: v.cpu() for k, v in models.hotword_params.state_dict().items()},
            "cpu")
        emb20_c = hotword.compile_hotwords(cpu_hw, models.hotword_cfg,
                                           list(hot20), models.vocab,
                                           seg_dict=models.seg_dict)
    hw_limit = HW_TOL * max(1.0, float(np.abs(emb20_c).max()))
    hw_err = float(np.abs(emb20 - emb20_c).max())
    if (emb20.shape != (21, models.asr_cfg.encoder.output_size)
            or not hw_err <= hw_limit):
        fail(f"hotword: 20 compiled hotwords {emb20.shape}, card vs cpu "
             f"{hw_err:.3e} (limit {hw_limit:.3e})")
    for n in (20, 200):
        hot = hotword_list(n, 2)
        models.compile_hotwords(hot)
        ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            models.compile_hotwords(hot)
            ms.append((time.perf_counter() - t1) * 1e3)
        numbers[f"compile_{n}_ms_p50"] = _pct(ms, 50)
    print(f"hotword: compile 20 hotwords card vs cpu max |err| {hw_err:.3e} "
          f"(limit {hw_limit:.3e}); compile ms (p50 of 5) 20 hotwords "
          f"{numbers['compile_20_ms_p50']:.2f}, 200 hotwords "
          f"{numbers['compile_200_ms_p50']:.2f} on {card}", flush=True)

    # recognize_batch: 16 x 15 s, 4 with 5 hotwords (6 rows, bucket 8),
    # 4 with 20 (21 rows, bucket 32), 8 with none: three forwards
    emb5 = models.compile_hotwords(hotword_list(5, 3))
    asr = ParaformerOffline(models.asr_params, models.asr_cfg, models.vocab,
                            cmvn=models.asr_cmvn)
    segs = [synth_audio(15.0, 500 + i) for i in range(HW_SEGMENTS)]
    hw_embs = [emb5] * 4 + [emb20] * 4 + [None] * 8
    forwards = []
    forward = asr._forward

    def logged(feats, lens, hw_batch=None, hw_lens=None):
        out = forward(feats, lens, hw_batch, hw_lens)
        forwards.append((feats.shape[0], feats.shape[1],
                         None if hw_batch is None else hw_batch.shape[1],
                         tuple(hw_lens or ())))
        if not all(torch.isfinite(getattr(out, k)).all() for k in (
                "logits", "us_alphas", "us_cif_peak")):
            fail("hotword: non-finite forward outputs")
        return out

    asr._forward = logged
    torch.cuda.synchronize()
    att.reset_launch_counts()
    outs = asr.recognize_batch(segs, hw_embs=hw_embs)
    torch.cuda.synchronize()
    launches = att.launch_counts_by_dtype()
    asr._forward = forward
    want_fwd = sorted([(4, 256, 8, (6,) * 4), (4, 256, 32, (21,) * 4),
                       (8, 256, None, ())], key=str)
    want = sum(50 + (16 if t // 2 + 8 >= 256 else 0)
               for _, t, _, _ in forwards)
    got = launches["mh_flash_attention"]["float32"]
    others = sum(n for name, by in launches.items() for dt, n in by.items()
                 if (name, dt) != ("mh_flash_attention", "float32"))
    print(f"hotword: recognize_batch {HW_SEGMENTS} x 15 s: forwards (B, "
          f"T, hotword rows, hotword counts) {forwards}; kernel launches "
          f"{launches} (expected mh_flash_attention fp32 {want})",
          flush=True)
    if (sorted(forwards, key=str) != want_fwd or got != want or others
            or not all(text and ts for text, ts in outs)):
        fail(f"hotword: recognize_batch ran forwards {forwards} and "
             f"launched {launches}; expected {want_fwd} and "
             f"mh_flash_attention fp32 {want} times and nothing else")

    # card vs CPU: one hotworded 15 s segment, front-end and forward
    fcfg = models.asr_cfg.frontend
    seg = segs[0]
    n_mel = num_frames(len(seg), fcfg)
    t_lfr = -(-n_mel // fcfg.lfr_n)
    with CLOCK.part("cpu"):
        cpu = ParaformerOffline(
            {k: v.cpu() for k, v in models.asr_params.state_dict().items()},
            models.asr_cfg, models.vocab, cmvn=models.asr_cmvn, device="cpu")
    res = []
    for rec_, dev in ((cpu, "cpu"), (asr, "cuda")):
        with CLOCK.part(on_cpu(dev)):
            feats = offline_frontend_device([seg], [n_mel], 256, fcfg,
                                            *models.asr_cmvn, batch_b=1,
                                            device=dev)
            with torch.inference_mode():
                out = rec_._forward(feats, [t_lfr], emb5[None],
                                    [emb5.shape[0]])
            res.append((int(out.token_num[0]), out.logits[0].cpu()))
    del cpu
    (n_c, l_c), (n_g, l_g) = res
    limit = CPU_TOL * max(1.0, l_c[:n_c].abs().max().item())
    err = ((l_g[:n_c] - l_c[:n_c]).abs().max().item() if n_g == n_c
           else float("inf"))
    print(f"hotword: card vs cpu, one 15 s segment with 5 hotwords: "
          f"token_num {n_g}/{n_c}, max |logits| err {err:.3e} (limit "
          f"{limit:.3e})", flush=True)
    if not err <= limit:
        fail(f"hotword: card vs cpu logits differ by {err:.3e}")
    numbers.update(hw_emb_max_abs_err=hw_err, logits_max_abs_err=err,
                   logits_limit=limit)

    # 16 x 60 s, every segment with the 20 hotwords and with none: one
    # forward at bucket 1024, 66 launches with hotwords too
    batch = [synth_audio(60.0, 100 + i) for i in range(16)]
    for label, embs in (("hotwords", [emb20] * 16), ("none", None)):
        asr.recognize_batch(batch, hw_embs=embs)
        torch.cuda.synchronize()
        att.reset_launch_counts()
        t1 = time.perf_counter()
        for _ in range(2):
            asr.recognize_batch(batch, hw_embs=embs)
        rate = 16 * 60.0 / ((time.perf_counter() - t1) / 2)
        n = att.launch_counts_by_dtype()["mh_flash_attention"]["float32"]
        numbers[f"rate_16x60_{label}"] = rate
        print(f"hotword: recognize_batch 16 x 60 s fp32, {label}: "
              f"{rate:.1f} audio-s/s on {card}; {n / 2:.0f} "
              f"mh_flash_attention launches a forward", flush=True)
        if n != 2 * 66:
            fail(f"hotword: 16 x 60 s ({label}) launched {n / 2} a forward")
    print(f"hotword: 9a {time.perf_counter() - t0:.1f} s", flush=True)
    return models, args, launches, numbers


def sensevoice_phase(tmp: str, gen, card: str):
    """9b. sensevoice_small() with a 20-block tp stack, saved as an svs
    dir and loaded back. Returns (svs dir, launches of the 60/150/270 s
    run, numbers)."""
    import torch

    from asr2pass_tpu_torch.config import sensevoice_small
    from asr2pass_tpu_torch.decode.context_graph import ContextGraph
    from asr2pass_tpu_torch.decode.ctc import ctc_prefix_beam_search_pruned
    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.models import sensevoice
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel.ctc_shard import ctc_first_prune_gather
    from asr2pass_tpu_torch.runtime import model_zoo
    from asr2pass_tpu_torch.runtime.sensevoice_asr import (
        SenseVoiceOffline, _merge_candidates, context_unit_ids)
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.utils import to_host

    t0 = time.perf_counter()
    cfg = sensevoice_small()
    tokens = cjk_tokens(cfg.vocab_size)
    with CLOCK.part("build"):
        svs_dir = save_svs_dir(tmp, gen)
        sb = model_zoo.load_svs_bundle(svs_dir)
        rec = SenseVoiceOffline(sb.params, sb.cfg, sb.vocab, cmvn=sb.cmvn)
    n_params = sum(p.numel() for p in rec.model.parameters())
    if rec.model.tp is None or len(rec.model.tp.rest) != SVS_TP_BLOCKS \
            or sb.cfg != cfg:
        fail("sensevoice: the svs dir does not load back its tp stack or "
             "configuration")
    print(f"sensevoice: sensevoice_small() + {SVS_TP_BLOCKS}-block tp "
          f"stack, {n_params} params, init+save+load "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    numbers = {"card": card}

    # 60, 150 and 270 s requests in one recognize_batch: one forward each
    # at T = 1028 (#1), 3076 (#2) and 5124 (#3), 50 + 20 launches each
    forwards = []
    forward = rec._forward

    def logged(feats, lens, *a):
        out = forward(feats, lens, *a)
        forwards.append(tuple(feats.shape[:2]))
        if not torch.isfinite(out.logits).all():
            fail("sensevoice: non-finite logits")
        return out

    rec._forward = logged
    audio = [synth_audio(s, seed) for s, seed in ((60.0, 1), (150.0, 2),
                                                  (270.0, 3))]
    torch.cuda.synchronize()
    att.reset_launch_counts()
    t1 = time.perf_counter()
    outs = rec.recognize_batch(audio, with_meta=True)
    dt = time.perf_counter() - t1
    launches = att.launch_counts_by_dtype()
    rec._forward = forward
    print(f"sensevoice: recognize_batch 60 + 150 + 270 s: {dt:.2f} s, "
          f"forwards (B, T) {forwards}, chars "
          f"{[len(t) for t, _, _ in outs]}, meta {[m for _, _, m in outs]}; "
          f"kernel launches {launches}", flush=True)
    blocks = cfg.encoder.num_blocks + SVS_TP_BLOCKS
    want = {"mh_flash_attention": blocks, "_attention_ss": blocks,
            "_attention_flash": blocks}
    if (sorted(forwards) != [(1, 1024), (1, 3072), (1, 5120)]
            or any(launches[k]["float32"] != n for k, n in want.items())
            or any(by["bfloat16"] for by in launches.values())
            or not all(t and len(m) == 4
                       and all(0 <= x < cfg.vocab_size for x in m)
                       for t, _, m in outs)):
        fail(f"sensevoice: forwards {forwards}, launches {launches}, "
             f"expected {want} in float32; texts and meta ids {outs}")

    # card vs CPU on one 15 s segment: logits, greedy ids, and the beam's
    # n-best with a 5-word context graph
    seg = synth_audio(15.0, 4)
    fcfg = cfg.frontend
    n_mel = num_frames(len(seg), fcfg)
    t_lfr = -(-n_mel // fcfg.lfr_n)
    with CLOCK.part("cpu"):
        cpu = SenseVoiceOffline({k: v.cpu() for k, v in
                                 rec.model.state_dict().items()},
                                sb.cfg, sb.vocab, cmvn=sb.cmvn, device="cpu")
    res = []
    for r, dev in ((cpu, "cpu"), (rec, "cuda")):
        with CLOCK.part(on_cpu(dev)):
            feats = offline_frontend_device([seg], [n_mel], 256, fcfg, *sb.cmvn,
                                            batch_b=1, device=dev)
            with torch.inference_mode():
                out = r._forward(feats, [t_lfr])
                greedy = sensevoice.greedy_ids(out)
            res.append((out, [x.cpu() for x in greedy]))
    (out_c, g_c), (out_g, g_g) = res
    n = int(g_c[1][0])
    ids_c = g_c[0][0, :n].tolist()
    # the context words: pairs of the greedy tokens, so the bias acts
    words = {"".join(sb.vocab.id2token(i) for i in ids_c[j: j + 2]): 40
             for j in range(0, 2 * SVS_CONTEXT_WORDS, 2)}
    ctx = ContextGraph().build(words)
    hw_ids = context_unit_ids(ctx, sb.vocab.token2id)
    nbest = []
    for out in (out_c, out_g):
        cid, clp, hw = to_host(list(ctc_first_prune_gather(out.logits,
                                                           hw_ids)))
        ln = int(out.lengths[0])
        fid, flp = _merge_candidates(cid[0, 4:ln], clp[0, 4:ln], hw_ids,
                                     hw[0, 4:ln])
        t1 = time.perf_counter()
        nbest.append(ctc_prefix_beam_search_pruned(
            fid, flp, ln - 4, beam=SVS_BEAM, context=ctx,
            id_to_token=sb.vocab.id2token, token2id=sb.vocab.token2id))
        beam_ms = (time.perf_counter() - t1) * 1e3
    lc, lg = out_c.logits[0].cpu(), out_g.logits[0].cpu()
    limit = CPU_TOL * max(1.0, lc.abs().max().item())
    err = (lg - lc).abs().max().item()
    same_greedy = all(torch.equal(a, b) for a, b in zip(g_c, g_g))
    same_nbest = [h[0] for h in nbest[0]] == [h[0] for h in nbest[1]]
    score_err = max(abs(a[1] - b[1]) for a, b in zip(*nbest))
    print(f"sensevoice: card vs cpu, one 15 s segment (T={t_lfr + 4}): max "
          f"|logits| err {err:.3e} (limit {limit:.3e}); greedy ids, counts "
          f"and meta equal {same_greedy} ({n} ids); beam {SVS_BEAM} with "
          f"a {len(words)}-word context graph: n-best equal {same_nbest}, "
          f"max score diff {score_err:.3e}, best {len(nbest[1][0][0])} "
          f"ids (greedy {n}); the beam took {beam_ms:.1f} ms on the host",
          flush=True)
    if not (err <= limit and same_greedy and same_nbest):
        fail("sensevoice: card and cpu differ")
    del cpu, out_c
    numbers.update(logits_max_abs_err=err, logits_limit=limit,
                   beam_15s_ms=beam_ms, beam_frames=t_lfr,
                   beam_candidates=64 + len(hw_ids))

    # the native beam against its Python spec on the card's candidates of
    # the 15 s segment and of a P9B_BEAM_SECONDS one, with no context and
    # with the 5-word context graph
    seg_long = synth_audio(P9B_BEAM_SECONDS, 5)
    n_mel_long = num_frames(len(seg_long), fcfg)
    t_long = -(-n_mel_long // fcfg.lfr_n)
    feats = offline_frontend_device([seg_long], [n_mel_long], 1024, fcfg,
                                    *sb.cmvn, batch_b=1, device="cuda")
    with torch.inference_mode():
        out_long = rec._forward(feats, [t_long])
    beams = {}
    for seconds, out in ((15, out_g), (int(P9B_BEAM_SECONDS), out_long)):
        cid, clp, hw = to_host(list(ctc_first_prune_gather(out.logits,
                                                           hw_ids)))
        ln = int(out.lengths[0])
        with CLOCK.part("cpu"):
            beams[f"{seconds}s_no_context"] = beam_gate(
                f"{seconds} s, no context", cid[0, 4:ln], clp[0, 4:ln],
                ln - 4, None, sb.vocab, card)
            fid, flp = _merge_candidates(cid[0, 4:ln], clp[0, 4:ln], hw_ids,
                                         hw[0, 4:ln])
            beams[f"{seconds}s_context"] = beam_gate(
                f"{seconds} s, {len(words)}-word context", fid, flp, ln - 4,
                ctx, sb.vocab, card)
    numbers["beam"] = beams
    del out_long

    # throughput: 16 x 60 s, greedy
    batch = [synth_audio(60.0, 100 + i) for i in range(16)]
    rec.recognize_batch(batch)
    torch.cuda.synchronize()
    att.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(2):
        rec.recognize_batch(batch)
    rate = 16 * 60.0 / ((time.perf_counter() - t1) / 2)
    n1 = att.launch_counts_by_dtype()["mh_flash_attention"]["float32"]
    numbers["rate_16x60_greedy"] = rate
    print(f"speed: SenseVoice recognize_batch 16 x 60 s fp32 greedy: "
          f"{rate:.1f} audio-s/s on {card}; {n1 / 2:.0f} "
          f"mh_flash_attention launches a forward (T = 1028)", flush=True)
    if n1 != 2 * blocks:
        fail(f"sensevoice: 16 x 60 s launched {n1 / 2} a forward")
    numbers["profile"] = device_profile(
        lambda: rec.recognize_batch(batch),
        "SenseVoice recognize_batch 16 x 60 s fp32")
    print(f"sensevoice: 9b {time.perf_counter() - t0:.1f} s", flush=True)
    return svs_dir, launches, numbers


def p9_server(models, args, label: str, firsts: list, card: str):
    """9c/9d/10c: the server on `models`, one paced connection of two
    bursts for each of the given first messages; 9d and 10c add a 60 s
    offline upload. Returns (the clients' (sends, msgs),
    bursts, record, launches, offline upload's messages, numbers). The
    record holds per pair its pass-2 options (`pairs`) and LM decoder
    (`lms`), and per connection the automaton's input (`vad_by`; c0's
    also in `vad`)."""
    import asyncio

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.metrics import GLOBAL as METRICS
    from asr2pass_tpu_torch.server.ws_server import AsrWsServer

    rec = {"ticks": [], "segs": {}, "fwd": [], "pairs": [], "vad": [],
           "uniform": [], "lms": [], "vad_by": {}}
    numbers = {"card": card}
    streams = [burst_stream(3000 + i, PACED_BURSTS)
               for i in range(len(firsts))]

    async def main():
        server = AsrWsServer(
            models, host=args.host, port=args.port,
            decode_workers=args.decode_workers, use_engine=True,
            engine_capacity=args.engine_capacity,
            max_message_bytes=args.max_message_mb << 20,
            max_upload_bytes=args.max_upload_mb << 20)
        srv = await server.serve()
        port = srv.sockets[0].getsockname()[1]
        eng = server.engine
        asr = eng.offline.asr

        def conn_name(sid, slot):
            conn = server._engine_conns.get(sid)
            return (conn[1].wav_name if conn is not None
                    and eng.slots[sid] is slot else None)

        step, process, recognize = (eng.step, eng._process_segments,
                                    asr.recognize_batch)
        forward, reset = asr._forward, eng._reset_slot
        current = []

        def timed_step():
            t1 = time.perf_counter()
            step()
            rec["ticks"].append(time.perf_counter() - t1)

        def logged_segments(pairs, settled=None):
            current[:] = pairs
            for sid, slot, fr in pairs:
                rec["segs"].setdefault(conn_name(sid, slot), []).append(
                    (fr.global_start, fr.global_end, len(fr.data)))
            return process(pairs, settled)

        def logged_recognize(segs, **kw):
            # per pair: its connection, and what its options gave pass 2
            for i, (sid, slot, _) in enumerate(current):
                rec["pairs"].append((
                    conn_name(sid, slot),
                    (kw.get("hw_embs") or [None] * len(segs))[i] is not None,
                    (kw.get("langs") or [None] * len(segs))[i],
                    (kw.get("contexts") or [None] * len(segs))[i]
                    is not None))
                rec["lms"].append((conn_name(sid, slot), (
                    kw.get("lm_decoders") or [None] * len(segs))[i]))
            return recognize(segs, **kw)

        def logged_forward(feats, lens, *a):
            rec["fwd"].append(tuple(feats.shape[:2]))
            if label == "9c" and a and a[0] is not None:
                # a hotword forward: every real row carries hotwords
                rec["uniform"].append(all(
                    h > 0 for n, h in zip(lens, a[1]) if n))
            return forward(feats, lens, *a)

        def recording_reset(sid):
            reset(sid)
            slot = eng.slots[sid]
            sm, name = slot.sm, []

            def call(scores, samples, is_final=False, **kw):
                ev = sm(scores, samples, is_final=is_final, **kw)
                if not name:
                    name.append(conn_name(sid, slot))
                rec["vad_by"].setdefault(name[0], []).append(
                    (samples.copy(), is_final, ev))
                if name[0] == "c0":
                    rec["vad"].append((samples.copy(), is_final, ev))
                return ev

            call.close = sm.close   # the engine frees what it made
            slot.sm = call

        eng.step, eng._process_segments = timed_step, logged_segments
        asr.recognize_batch, asr._forward = logged_recognize, logged_forward
        eng._reset_slot = recording_reset
        prof = profile(activities=[ProfilerActivity.CUDA])
        trace = {}

        async def traced_window():
            await asyncio.sleep(TRACE_AT_S)
            n0 = len(rec["ticks"])
            prof.start()
            t1 = time.perf_counter()
            deadline = t1 + 60
            while (len(rec["ticks"]) < n0 + TRACE_TICKS
                   and time.perf_counter() < deadline):
                await asyncio.sleep(0.01)
            trace["wall_ms"] = (time.perf_counter() - t1) * 1e3
            trace["ticks"] = len(rec["ticks"]) - n0
            prof.stop()

        try:
            METRICS.reset()
            torch.cuda.synchronize()
            att.reset_launch_counts()
            nb.reset_call_counts()
            t1 = time.perf_counter()
            tracer = asyncio.create_task(traced_window())
            clients = await asyncio.gather(*[
                ws_client(port, f"c{i}", data, "2pass", PACE_S,
                          i * PACE_S / len(firsts), first=first(f"c{i}"))
                for i, ((data, _), first) in enumerate(zip(streams,
                                                           firsts))])
            await tracer
            numbers["wall_s"] = time.perf_counter() - t1
            launches = att.launch_counts_by_dtype()
            numbers["native_calls"] = nb.call_counts()
            numbers["stages"] = {
                k: [v["p50_ms"], v["p95_ms"], v["count"]]
                for k, v in METRICS.report()["stages"].items()}
            offline = None
            if label in ("9d", "10c"):
                # one 60 s offline upload through the pass 2 (no
                # hotwords: SenseVoice greedy; 10c with the LM)
                _, offline = await ws_client(
                    port, "off", s16_bytes(synth_audio(60.0, 1)), "offline",
                    first=reference_first_message("offline", "off",
                                                  hotwords=""))
        finally:
            server._engine_task.cancel()
            srv.close()
            await srv.wait_closed()
            server.engine.shutdown()
            server.executor.shutdown(wait=False)
            server._offline_executor.shutdown(wait=False)
        t1 = time.perf_counter()
        busy = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0) / 1e3
        numbers["trace_read_s"] = time.perf_counter() - t1
        if trace.get("ticks"):
            numbers["trace_idle_share"] = (1 - busy / trace["wall_ms"]
                                           if busy else None)
            numbers["trace_wall_ms"] = trace["wall_ms"]
        return clients, launches, offline

    clients, launches, offline = asyncio.run(main())
    partial, final = [], []
    for (sends, msgs), (_, spans) in zip(clients, streams):
        p, f = server_latencies(sends, msgs, spans)
        partial += p
        final += f
    numbers.update({
        "partial_ms_p50": _pct(partial, 50), "partial_ms_p95": _pct(partial, 95),
        "final_ms_p50": _pct(final, 50), "final_ms_p95": _pct(final, 95),
        "tick_ms_p50": _pct([x * 1e3 for x in rec["ticks"]], 50),
        "tick_ms_p95": _pct([x * 1e3 for x in rec["ticks"]], 95),
        "pass2_forwards": [list(s) for s in rec["fwd"]]})
    idle = numbers.get("trace_idle_share")
    print(f"server: {label}, {len(firsts)} paced connections, "
          f"{numbers['wall_s']:.1f} s: partial p50/p95 "
          f"{numbers['partial_ms_p50']:.1f} / {numbers['partial_ms_p95']:.1f}"
          f" ms; final p50/p95 {numbers['final_ms_p50']:.1f} / "
          f"{numbers['final_ms_p95']:.1f} ms; tick p50/p95 "
          f"{numbers['tick_ms_p50']:.1f} / {numbers['tick_ms_p95']:.1f} ms; "
          f"engine idle share "
          + (f"{idle:.3f}" if idle is not None else "not measured")
          + f" over {TRACE_TICKS} ticks; pass-2 forwards (B, T) "
          f"{rec['fwd']}; stages (p50, p95 ms, count) "
          f"{json.dumps(numbers['stages'])}; native calls "
          f"{numbers['native_calls']} on {card}", flush=True)
    if not numbers["native_calls"]["vad_chunk"]:
        fail(f"server: {label}'s automatons made no native call")
    return clients, streams, rec, launches, offline, numbers


def hotword_server_phase(models, args, card: str):
    """9c: the deployed hotword 2pass, --engine at capacity 128: 16 paced
    connections, 8 with hotwords in the first message."""
    t0 = time.perf_counter()
    hots = [hotword_list(5, 10 + i) if i % 2 == 0 else None
            for i in range(P9_CONNECTIONS)]
    firsts = [lambda name, h=h: reference_first_message(
        "2pass", name, hotwords=json.dumps(h) if h else "")
        for h in hots]
    clients, streams, rec, launches, _, numbers = p9_server(
        models, args, "9c", firsts, card)
    fcfg = models.asr_cfg.frontend
    for i, ((_, msgs), (_, spans)) in enumerate(zip(clients, streams)):
        check_stream(f"c{i}", msgs, spans, rec["segs"].get(f"c{i}", []),
                     fcfg)
    hotworded = {f"c{i}" for i, h in enumerate(hots) if h}
    wrong = [(n, hw) for n, hw, _, _ in rec["pairs"]
             if hw != (n in hotworded)]
    if wrong or len(rec["pairs"]) != PACED_BURSTS * P9_CONNECTIONS \
            or not all(rec["uniform"]):
        fail(f"server: 9c hotword embeddings reached pass 2 for the wrong "
             f"segments {wrong} ({len(rec['pairs'])} segments; forwards "
             f"homogeneous {rec['uniform']})")
    want = sum(50 + (16 if t // 2 + 8 >= 256 else 0)
               for _, t in rec["fwd"] if t >= 256)
    got = launches["mh_flash_attention"]["float32"]
    others = sum(n for name, by in launches.items() for dt, n in by.items()
                 if (name, dt) != ("mh_flash_attention", "float32"))
    if want == 0 or got != want or others:
        fail(f"server: 9c launched {launches}, expected mh_flash_attention "
             f"{want} times in float32")
    # c0 (hotworded) against a TwoPassSession with the same embeddings on
    # the chunks the engine's automaton took for c0
    sess = models.create_session(
        mode="offline", vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000,
        hw_emb=models.compile_hotwords(hots[0]), use_itn=True)
    sess_finals = [r.final_text for r in (
        sess.feed(samples, fin) for samples, fin, _ in rec["vad"])
        if r.final_text]
    eng_finals = [m["text"] for _, m in clients[0][1]
                  if m["mode"] == "2pass-offline"]
    print(f"server: 9c kernel launches {launches} (expected "
          f"mh_flash_attention fp32 {want}); hotworded segments "
          f"{sum(hw for _, hw, _, _ in rec['pairs'])} of "
          f"{len(rec['pairs'])}, each in a hotword forward; c0 finals equal "
          f"a create_session(hw_emb=...) session's: "
          f"{sess_finals == eng_finals}", flush=True)
    if sess_finals != eng_finals or not eng_finals:
        fail(f"server: 9c c0 finals {eng_finals} differ from the session's "
             f"{sess_finals}")
    print(f"server: 9c {json.dumps(numbers)}", flush=True)
    print(f"server: 9c {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, numbers


def svs_server_phase(args, svs_dir: str, card: str):
    """9d: the same launch with --svs-dir (deploy/servers.yaml's
    SenseVoice entry at capacity 128): 16 paced connections, svs_lang
    cycling zh, en, auto, 4 with hotwords; then a 60 s offline upload."""
    from asr2pass_tpu_torch.frontend.audio import load_pcm_bytes
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.server.run_server import build_models, parser

    t0 = time.perf_counter()
    argv = [a for k, v in vars(args).items() if k in (
        "model_dir", "online_model_dir", "vad_dir", "punc_dir")
        for a in (f"--{k.replace('_', '-')}", v)]
    args = parser().parse_args(argv + [
        "--svs-dir", svs_dir, "--engine", "--engine-capacity",
        str(ENGINE_CAPACITY), "--host", "127.0.0.1", "--port", "0"])
    with CLOCK.part("build"):
        models = build_models(args)
    print(f"server: 9d models with --svs-dir loaded "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    hots = [hotword_list(3, 20 + i) if i % 4 == 0 else None
            for i in range(P9_CONNECTIONS)]
    langs = [SVS_LANGS[i % 3] for i in range(P9_CONNECTIONS)]
    firsts = [lambda name, h=h, lang=lang: reference_first_message(
        "2pass", name, svs_lang=lang, hotwords=json.dumps(h) if h else "")
        for h, lang in zip(hots, langs)]
    clients, streams, rec, launches, offline, numbers = p9_server(
        models, args, "9d", firsts, card)
    fcfg = models.svs_cfg.frontend
    for i, ((_, msgs), (_, spans)) in enumerate(zip(clients, streams)):
        check_stream(f"c{i}", msgs, spans, rec["segs"].get(f"c{i}", []),
                     fcfg, stamps=False)
    wrong = [p for p in rec["pairs"]
             if p[0] is None or p[2] != langs[int(p[0][1:])]
             or p[3] != (hots[int(p[0][1:])] is not None)]
    if wrong or len(rec["pairs"]) != PACED_BURSTS * P9_CONNECTIONS:
        fail(f"server: 9d segments reached SenseVoice with the wrong "
             f"options: {wrong}")
    # each hotworded segment took the native beam, once; the others greedy
    n_ctx = sum(1 for p in rec["pairs"] if p[3])
    beams = numbers["native_calls"]["ctc_beam_decode"]
    print(f"native: 9d beam {beams} native calls for {n_ctx} hotworded "
          f"segments; final p50/p95 {numbers['final_ms_p50']:.1f} / "
          f"{numbers['final_ms_p95']:.1f} ms, partial p50/p95 "
          f"{numbers['partial_ms_p50']:.1f} / "
          f"{numbers['partial_ms_p95']:.1f} ms (the Python beam's, ms: "
          + ", ".join(f"{k} {a}-{b}" for k, (a, b)
                      in PYTHON_BEAM_9D_MS.items())
          + f") on {card}", flush=True)
    if beams != n_ctx or not n_ctx:
        fail(f"server: 9d ran the native beam {beams} times for {n_ctx} "
             "hotworded segments")
    blocks = models.svs_cfg.encoder.num_blocks + len(
        models.svs_params.tp.rest)
    want = blocks * sum(t + 4 >= 256 for _, t in rec["fwd"])
    got = launches["mh_flash_attention"]["float32"]
    others = sum(n for name, by in launches.items() for dt, n in by.items()
                 if (name, dt) != ("mh_flash_attention", "float32"))
    print(f"server: 9d kernel launches {launches} (expected "
          f"mh_flash_attention fp32 {want} = {blocks} x the forwards at "
          f"T = 260)", flush=True)
    if want == 0 or got != want or others:
        fail(f"server: 9d launched {launches}, expected {want}")
    ms = [m for _, m in offline]
    ref = models.create_offline_recognizer(
        vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000,
        use_svs=True).transcribe(
        load_pcm_bytes(s16_bytes(synth_audio(60.0, 1))), use_itn=True)
    if (not isinstance(models.create_offline_recognizer(use_svs=True).asr,
                       SenseVoiceOffline)
            or len(ms) != 1 or ms[0]["mode"] != "offline"
            or ms[0]["text"] != ref.text or not ref.text):
        fail(f"server: 9d offline upload gave {ms}, transcribe gives "
             f"{ref.text!r}")
    print(f"server: 9d, 60 s offline upload through SenseVoice: one final, "
          f"{len(ms[0]['text'])} chars, equal to OfflineRecognizer."
          f"transcribe", flush=True)
    print(f"server: 9d {json.dumps(numbers)}", flush=True)
    print(f"server: 9d {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, numbers


def phase9(tmp: str, gen, card: str):
    """Phase 9. Returns ({path: launches by entry point and dtype},
    {sub-phase: numbers})."""
    with CLOCK.phase("9a"):
        models, args, l_hw, n_hw = hotword_phase(tmp, gen, card)
    with CLOCK.phase("9b"):
        svs_dir, l_svs, n_svs = sensevoice_phase(tmp, gen, card)
    with CLOCK.phase("9c"):
        l_hw_srv, n_hw_srv = hotword_server_phase(models, args, card)
    del models
    with CLOCK.phase("9d"):
        l_svs_srv, n_svs_srv = svs_server_phase(args, svs_dir, card)
    return ({"hotword": l_hw, "svs": l_svs, "hotword_engine": l_hw_srv,
             "svs_engine": l_svs_srv},
            {"9a": n_hw, "9b": n_svs, "9c": n_hw_srv, "9d": n_svs_srv})


P10_VOCAB = 8404          # paraformer_large's vocabulary: the corpus's units
P10_WORDS = 1500          # the LM's word vocabulary (1-3 CJK tokens a word)
P10_SENTENCES = 6000      # its training corpus, Zipf-drawn from the seed
P10_ORDER = 3
P10_SEGMENTS = 16         # 10a: 16 x 15 s; 10b: 16 x 60 s
P10B_LM_EVERY = 8         # 10b: every 8th item with a TlgDecoder (2 of 16)
P10C_CONNECTIONS = 8      # 10c: paced connections, every other hotworded
P10_HOTWORDS = 5
LM_SHARPEN = 20.0         # 10a: the boost that makes a card row name its unit
LM_TIMING_REPS = 5


def lm_phase_dirs(tmp: str, tokens: list, card: str) -> dict:
    """Phase 10's LM and grammars, made with the port's tools: a corpus
    drawn from the seed over the Paraformer vocabulary's CJK tokens,
    tools/build_lm (lm.arpa + lexicon.txt, order 3), tools/build_tlg of
    it in the per-token and the CTC topology, and a toy ITN grammar pair
    over every token. Returns the dirs and what the phase needs."""
    import numpy as np

    from asr2pass_tpu_torch.decode.lm_decoder import Lexicon
    from asr2pass_tpu_torch.decode.ngram import NgramLM
    from asr2pass_tpu_torch.decode.tlg import TlgGraph
    from asr2pass_tpu_torch.tools import build_lm, build_tlg

    rng = np.random.default_rng(10)
    units = tokens[4:]
    words, seen = [], set()
    while len(words) < P10_WORDS:
        w = "".join(units[int(k)] for k in rng.integers(
            0, len(units), rng.integers(1, 4)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    p = 1.0 / np.arange(1, P10_WORDS + 1) ** 1.1
    p /= p.sum()
    sents = [[words[int(k)] for k in rng.choice(P10_WORDS,
                                                rng.integers(4, 16), p=p)]
             for _ in range(P10_SENTENCES)]
    d = {k: os.path.join(tmp, k) for k in ("lm", "tlg", "ctc", "itn")}
    os.makedirs(tmp, exist_ok=True)
    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(" ".join(s) for s in sents) + "\n")
    numbers = {"card": card}
    t0 = time.perf_counter()
    build_lm.main([corpus, d["lm"], "--order", str(P10_ORDER)])
    numbers["build_lm_s"] = time.perf_counter() - t0
    arpa, lex = (os.path.join(d["lm"], n) for n in ("lm.arpa",
                                                    "lexicon.txt"))
    for name, extra in (("tlg", []), ("ctc", ["--ctc-blank", "<blank>"])):
        t0 = time.perf_counter()
        build_tlg.main(["--arpa", arpa, "--lexicon", lex, "--out", d[name],
                        *extra])
        numbers[f"build_tlg_{name}_s"] = time.perf_counter() - t0
    lm = NgramLM.load_arpa(arpa)
    token2id = {t: i for i, t in enumerate(tokens)}
    numbers["ngrams"] = len(lm.logp)
    for name in ("tlg", "ctc"):
        g = TlgGraph(d[name], token2id)
        numbers[f"{name}_graph"] = {
            "states": g.fst.num_states, "arcs": g.fst.num_arcs,
            "bytes": os.path.getsize(os.path.join(d[name], "TLG.fst"))}
        g.fst.close()
    rewrite = {u: str(k % 10) for k, u in enumerate(units) if k % 3 == 0}
    toy_itn_dir(d["itn"], units, rewrite)
    print(f"lm: {numbers['ngrams']} n-grams of order {P10_ORDER} over "
          f"{P10_WORDS} words ({P10_SENTENCES} sentences), build_lm "
          f"{numbers['build_lm_s']:.1f} s; TLG {numbers['tlg_graph']} in "
          f"{numbers['build_tlg_tlg_s']:.1f} s, CTC TLG "
          f"{numbers['ctc_graph']} in {numbers['build_tlg_ctc_s']:.1f} s "
          f"(build_tlg limit 60 s) on the card's host", flush=True)
    if max(numbers["build_tlg_tlg_s"], numbers["build_tlg_ctc_s"]) > 60:
        fail("lm: build_tlg took more than 60 s")
    return dict(dirs=d, lm=lm, lexicon=Lexicon.from_file(lex), sents=sents,
                words=words, rewrite=rewrite, numbers=numbers)


def toy_itn_dir(out_dir: str, units: list, rewrite: dict):
    """zh_itn_tagger.fst / zh_itn_verbalizer.fst over every unit and the
    punctuation marks: the units in `rewrite` become its digits
    (`cardinal` tokens, the cheaper path), the rest pass through as
    `char` tokens. Both grammars share prefixes in byte tries, so a
    composition walks one branch a byte."""
    from asr2pass_tpu_torch.decode.fst_io import FstBuilder

    def trie_add(b, trie, start, data: bytes, olabels=()):
        """Input bytes from `start` along shared trie states (epsilon
        output); returns the state after the last byte."""
        cur = start
        for byte in data:
            key = (cur, byte)
            if key not in trie:
                trie[key] = b.new_state()
                b.add_arc(cur, byte, 0, 0.0, trie[key])
            cur = trie[key]
        return cur

    def emit(b, src, out: bytes, w, dst):
        """Epsilon-input chain writing `out` from src to dst."""
        cur = src
        for k, byte in enumerate(out):
            nxt = dst if k == len(out) - 1 else b.new_state()
            b.add_arc(cur, 0, byte, w if k == 0 else 0.0, nxt)
            cur = nxt

    chars = list(units) + list("，。？、！")
    tag, trie = FstBuilder(), {}
    tag.set_final(tag.start)
    for c in chars:
        end = trie_add(tag, trie, tag.start, c.encode())
        emit(tag, end, f'char {{ value: "{c}" }} '.encode(), 1.0, tag.start)
        if c in rewrite:
            emit(tag, end, f'cardinal {{ value: "{rewrite[c]}" }} '.encode(),
                 0.5, tag.start)
    verb, trie = FstBuilder(), {}
    verb.set_final(verb.start)
    verb.add_arc(verb.start, ord(" "), 0, 0.0, verb.start)
    for c in chars:
        end = trie_add(verb, trie, verb.start, f'char {{ value: "{c}'.encode())
        tail = trie_add(verb, trie, end, b'" }', ())
        emit(verb, tail, c.encode(), 0.0, verb.start)
    for digit in sorted(set(rewrite.values())):
        end = trie_add(verb, trie, verb.start,
                       f'cardinal {{ value: "{digit}" }}'.encode())
        emit(verb, end, digit.encode(), 0.0, verb.start)
    os.makedirs(out_dir, exist_ok=True)
    tag.write(os.path.join(out_dir, "zh_itn_tagger.fst"))
    verb.write(os.path.join(out_dir, "zh_itn_verbalizer.fst"))


def lm_hotwords(lm_setup: dict, offset: int = 0) -> dict:
    """P10_HOTWORDS words of the LM, of two or more units: a bias that
    can change what the LM picks."""
    ws = [w for w in lm_setup["words"] if len(w) > 1]
    return {w: 10 for w in ws[offset: offset + P10_HOTWORDS]}


class RecordingDecoder:
    """An LM decoder that keeps each row set it decodes (the recognizer
    calls start_utterance, then decode)."""

    def __init__(self, dec):
        self.dec, self.rows, self.texts = dec, [], []

    def start_utterance(self):
        self.dec.start_utterance()

    def decode(self, rows, id_to_token):
        self.rows.append(rows.copy())
        self.texts.append(self.dec.decode(rows, id_to_token))
        return self.texts[-1]


def recording_tlg(graph, token2id, **kw):
    """A TlgDecoder that keeps each set of label rows it decodes."""
    from asr2pass_tpu_torch.decode.tlg import TlgDecoder

    class RecordingTlg(TlgDecoder):
        def decode_ilabel_rows(self, rows):
            self.rows.append(rows.copy())
            return super().decode_ilabel_rows(rows)

    dec = RecordingTlg(graph, token2id, **kw)
    dec.rows = []
    return dec


def sharpened(rows, units: list, token2id: dict):
    """The card's rows [n, V] with each of the first len(units) rows
    boosted by LM_SHARPEN at its unit and renormalized: rows on which the
    best path spells `units` whatever the decoder."""
    import numpy as np

    x = rows[: len(units)].astype(np.float64)
    x[np.arange(len(units)), [token2id[u] for u in units]] += LM_SHARPEN
    m = x.max(-1, keepdims=True)
    x -= m + np.log(np.exp(x - m).sum(-1, keepdims=True))
    return x.astype(np.float32)


def lm_offline_phase(model_dir: str, lm_setup: dict, card: str):
    """10a: the phase-3 paraformer_large(timestamp=True) dir rescored by
    the native LM decoder, 16 x 15 s in one recognize_batch, without and
    with hotwords, then by a TLG decoder. Returns (launches, numbers)."""
    import numpy as np
    import torch

    from asr2pass_tpu_torch.decode.context_graph import ContextGraph
    from asr2pass_tpu_torch.decode.lm_decoder import LmDecoder
    from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
    from asr2pass_tpu_torch.native.bindings import NativeLmDecoder
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime import model_zoo
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        b = model_zoo.load_offline_bundle(model_dir)
        asr = ParaformerOffline(b.params, b.cfg, b.vocab, cmvn=b.cmvn)
    vocab, lm, lex = b.vocab, lm_setup["lm"], lm_setup["lexicon"]
    base = NativeLmDecoder(lm, lex, vocab.token2id)
    py = LmDecoder(lm, lex)
    segs = [synth_audio(15.0, 700 + i) for i in range(P10_SEGMENTS)]
    numbers = {"card": card}
    v = b.cfg.vocab_size

    def run(decs, label):
        forwards, forward = [], asr._forward

        def logged(feats, lens, *a):
            forwards.append(tuple(feats.shape[:2]))
            out = forward(feats, lens, *a)
            numbers[f"logits_bytes_{label}"] = out.logits.numel() * 4
            return out

        asr._forward, asr.lm_bytes_copied = logged, 0
        torch.cuda.synchronize()
        att.reset_launch_counts()
        t1 = time.perf_counter()
        outs = asr.recognize_batch(segs, lm_decoders=decs)
        numbers[f"{label}_s"] = time.perf_counter() - t1
        asr._forward = forward
        numbers[f"lm_bytes_{label}"] = asr.lm_bytes_copied
        return outs, forwards, att.launch_counts_by_dtype()

    # no hotwords: the shared native decoder; its rows against the Python
    # decoder's texts on the same rows
    recs = [RecordingDecoder(base) for _ in segs]
    outs, forwards, launches = run(recs, "native")
    n_tok = [len(r.rows[0]) if r.rows else 0 for r in recs]
    rows = [r.rows[0] for r in recs if r.rows]
    with CLOCK.part("cpu"):
        py_texts = [py.decode(x, vocab.id2token) for x in rows]
    nat_texts = [r.texts[0] for r in recs if r.texts]
    same_py = sum(a == b for a, b in zip(nat_texts, py_texts))
    in_outs = all(o[0] == r.texts[0] for o, r in zip(outs, recs) if r.texts)
    want_bytes = sum(n_tok) * v * 4
    print(f"lm: 10a recognize_batch {P10_SEGMENTS} x 15 s with the native "
          f"LM decoder: {numbers['native_s']:.2f} s, forwards (B, T) "
          f"{forwards}, launches {launches}; tokens {n_tok}; rows copied "
          f"{numbers['lm_bytes_native']} bytes (the count rows: "
          f"{want_bytes}; the forward's logits: "
          f"{numbers['logits_bytes_native']}); native = Python LmDecoder "
          f"on the card's rows: {same_py} of {len(rows)}", flush=True)
    want_l = 50 * len(forwards)
    if (len(rows) != P10_SEGMENTS or same_py != len(rows) or not in_outs
            or numbers["lm_bytes_native"] != want_bytes
            or launches["mh_flash_attention"]["float32"] != want_l
            or any(n for name, by in launches.items()
                   for dt, n in by.items()
                   if (name, dt) != ("mh_flash_attention", "float32"))):
        fail("lm: 10a native LM decoding differs from the Python decoder, "
             "from the recognizer's texts, or copied other rows than the "
             f"LM items' ({same_py}/{len(rows)}, {in_outs}, "
             f"{numbers['lm_bytes_native']} bytes) or launched {launches}")
    lm_launches = launches
    # with hotwords: the clone against a decoder built with them. Each
    # hotword pairs the runner-up units of two adjacent rows of one
    # segment, so that the bias competes with what the LM picked
    hot = {}
    for k in range(P10_HOTWORDS):
        units = [next(vocab.id2token(int(u)) for u in np.argsort(-x)[1:]
                      if u >= 4)
                 for x in rows[k % len(rows)][3 * k + 2: 3 * k + 4]]
        hot["".join(units)] = 10
    clone, fresh = base.clone(hot), NativeLmDecoder(lm, lex, vocab.token2id,
                                                    hotwords=hot)
    py_hot = LmDecoder(lm, lex, bias=ContextGraph().build(hot))
    recs_h = [RecordingDecoder(clone) for _ in segs]
    outs_h, _, _ = run(recs_h, "clone")
    rows_h = [r.rows[0] for r in recs_h if r.rows]
    fresh_texts = [fresh.decode(x, vocab.id2token) for x in rows_h]
    with CLOCK.part("cpu"):
        pyh_texts = [py_hot.decode(x, vocab.id2token) for x in rows_h]
    clone_texts = [r.texts[0] for r in recs_h if r.texts]
    same_fresh = sum(a == b for a, b in zip(clone_texts, fresh_texts))
    same_pyh = sum(a == b for a, b in zip(clone_texts, pyh_texts))
    biased = sum(a != b for a, b in zip(clone_texts, nat_texts))
    print(f"lm: 10a with {len(hot)} hotwords: the clone = a NativeLmDecoder "
          f"built with them on {same_fresh} of {len(rows_h)} segments, = "
          f"the Python decoder with the context graph on {same_pyh}; the "
          f"bias changed {biased} texts", flush=True)
    if (same_fresh != len(rows_h) or same_pyh != len(rows_h) or not rows_h
            or not biased):
        fail("lm: 10a the hotworded clone differs from a decoder built "
             "with the hotwords, or the bias changed nothing")
    # the TLG decoder: rows gathered on the card, in the recognizer
    graph = TlgGraph(lm_setup["dirs"]["tlg"], vocab.token2id)
    recs_t = [recording_tlg(graph, vocab.token2id) for _ in segs]
    outs_t, _, _ = run(recs_t, "tlg")
    g = len(graph.gather)
    host = [graph.gather_rows(torch.from_numpy(x)).numpy() for x in rows]
    gather_err = max(float(np.abs(r.rows[0] - h).max())
                     for r, h in zip(recs_t, host))
    tlg_same = sum(o[0] == n for o, n in zip(outs_t, nat_texts))
    print(f"lm: 10a TLG decoder in the recognizer: rows gathered on the "
          f"card to {g} labels, {numbers['lm_bytes_tlg']} bytes copied "
          f"(count rows {sum(n_tok) * g * 4}), max |card gather - host "
          f"gather| {gather_err:.3e}; texts equal the native LM decoder's "
          f"on {tlg_same} of {P10_SEGMENTS} raw segments", flush=True)
    if (numbers["lm_bytes_tlg"] != sum(n_tok) * g * 4
            or not gather_err <= 1e-5):
        fail("lm: 10a the TLG rows gathered on the card differ from the "
             "host gather")
    # on the card's rows sharpened to an LM sentence each (as
    # tests/test_fst_runtime.py:274 holds it): TLG = native = Python
    agree = 0
    tlg = TlgDecoder(graph, vocab.token2id)
    for k, x in enumerate(rows):
        sent = next(s for s in lm_setup["sents"][k * 7:]
                    if len("".join(s)) <= len(x))
        units = list("".join(sent))
        y = sharpened(x, units, vocab.token2id)
        tlg.start_utterance()
        t = tlg.decode(y)
        agree += (t == "".join(sent) == base.decode(y, vocab.id2token)
                  == py.decode(y, vocab.id2token))
    print(f"lm: 10a on the card's rows sharpened to an LM sentence: TLG = "
          f"native = Python = the sentence on {agree} of {len(rows)}",
          flush=True)
    if agree != len(rows):
        fail("lm: 10a the TLG decoder and the LM decoders disagree on "
             "unambiguous rows")
    tlg.close()
    numbers.update(tokens=n_tok, native_eq_python=same_py,
                   clone_eq_fresh=same_fresh, tlg_eq_native_raw=tlg_same,
                   gather_max_abs_err=gather_err, texts_biased=biased)
    # the native table: decode against LmDecoder on 15 s and 60 s rows,
    # with and without the hotwords
    rec60 = RecordingDecoder(base)
    asr.recognize_batch([synth_audio(60.0, 790)], lm_decoders=[rec60])
    table = {}
    for seconds, x in ((15, rows[0]), (60, rec60.rows[0])):
        for label, nat, plain in (("no_hotwords", base, py),
                                  (f"{len(hot)}_hotwords", clone, py_hot)):
            _, ms = host_ms(lambda: nat.decode(x, vocab.id2token),
                            LM_TIMING_REPS)
            with CLOCK.part("cpu"):
                _, pms = host_ms(lambda: plain.decode(x, vocab.id2token), 1)
            table[f"{seconds}s_{label}"] = {
                "rows": int(len(x)), "native_ms": ms, "plain_ms": pms}
            print(f"native: LM decode {seconds} s ({len(x)} rows), {label}: "
                  f"native {ms:.2f} ms, Python {pms:.2f} ms "
                  f"({pms / ms:.1f}x) on {card}", flush=True)
    numbers["decode"] = table
    clone.close()
    print(f"lm: 10a {time.perf_counter() - t0:.1f} s", flush=True)
    return lm_launches, numbers


def lm_svs_phase(svs_dir: str, lm_setup: dict, card: str):
    """10b: 9b's sensevoice_small() dir with TLG rescoring over the CTC
    graph: 16 x 60 s in one recognize_batch, every P10B_LM_EVERY-th item
    with its own TlgDecoder. Returns (launches, numbers)."""
    import torch

    from asr2pass_tpu_torch.decode.tlg import TlgDecoder, TlgGraph
    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.frontend.lfr import lfr_len
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime import model_zoo
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        sb = model_zoo.load_svs_bundle(svs_dir)
        rec = SenseVoiceOffline(sb.params, sb.cfg, sb.vocab, cmvn=sb.cmvn)
    numbers = {"card": card}
    # a per-token graph is refused: SenseVoice decodes CTC frames
    flat = TlgDecoder(lm_setup["dirs"]["tlg"], sb.vocab.token2id)
    try:
        SenseVoiceOffline(rec.model, sb.cfg, sb.vocab, lm_decoder=flat)
        fail("lm: 10b SenseVoice took a graph without the CTC topology")
    except ValueError as e:
        print(f"lm: 10b a per-token graph is refused: {e}", flush=True)
    flat.close()
    graph = TlgGraph(lm_setup["dirs"]["ctc"], sb.vocab.token2id)
    batch = [synth_audio(60.0, 800 + i) for i in range(P10_SEGMENTS)]
    base = rec.recognize_batch(batch)
    decs = [recording_tlg(graph, sb.vocab.token2id)
            if i % P10B_LM_EVERY == 0 else None
            for i in range(P10_SEGMENTS)]
    rec.lm_bytes_copied = 0
    torch.cuda.synchronize()
    att.reset_launch_counts()
    t1 = time.perf_counter()
    outs = rec.recognize_batch(batch, lm_decoders=decs)
    numbers["recognize_s"] = time.perf_counter() - t1
    launches = att.launch_counts_by_dtype()
    fcfg = sb.cfg.frontend
    frames = [lfr_len(num_frames(len(w), fcfg), fcfg.lfr_m, fcfg.lfr_n)
              for w in batch]
    g = len(graph.gather)
    lm_items = [i for i, d in enumerate(decs) if d is not None]
    want_bytes = sum(frames[i] for i in lm_items) * g * 4
    full = P10_SEGMENTS * (1024 + 4) * sb.cfg.vocab_size * 4
    allowed = set("".join(lm_setup["words"]))
    plain_same = all(outs[i] == base[i] for i in range(P10_SEGMENTS)
                     if decs[i] is None)
    in_vocab = all(set(outs[i][0]) <= allowed for i in lm_items)
    numbers.update(lm_bytes=rec.lm_bytes_copied, logits_bytes=full,
                   lm_chars=[len(outs[i][0]) for i in lm_items])
    blocks = sb.cfg.encoder.num_blocks + len(rec.model.tp.rest)
    print(f"lm: 10b SenseVoice recognize_batch {P10_SEGMENTS} x 60 s, "
          f"{len(lm_items)} with a TlgDecoder over the CTC graph: "
          f"{numbers['recognize_s']:.2f} s; launches {launches} (expected "
          f"mh_flash_attention fp32 {blocks}); rows copied "
          f"{rec.lm_bytes_copied} bytes ([T, {g}] of the LM items: "
          f"{want_bytes}; the [B, T, V] logits would be {full}); items "
          f"without an LM equal a batch with no LM: {plain_same}; LM texts "
          f"{numbers['lm_chars']} chars, all of the graph's words: "
          f"{in_vocab}", flush=True)
    if (not plain_same or not in_vocab or not any(numbers["lm_chars"])
            or rec.lm_bytes_copied != want_bytes
            or launches["mh_flash_attention"]["float32"] != blocks):
        fail("lm: 10b the SenseVoice TLG batch fails its gates")
    # the TLG search per frame, on one LM item's rows
    rows = decs[0].rows[0]
    dec = TlgDecoder(graph, sb.vocab.token2id)

    def one():
        dec.start_utterance()
        return dec.decode_ilabel_rows(rows)

    text, ms = host_ms(one, 1)
    if text != outs[0][0]:
        fail("lm: 10b the TLG decode of the fetched rows differs from the "
             "recognizer's text")
    numbers["tlg_ms_per_frame"] = ms / len(rows)
    numbers["tlg_frames"] = len(rows)
    print(f"native: TLG decode 60 s ({len(rows)} frames x {g} labels): "
          f"{ms:.1f} ms, {ms / len(rows):.3f} ms a frame on {card}",
          flush=True)
    for d in decs:
        if d is not None:
            d.close()
    dec.close()
    print(f"lm: 10b {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, numbers


class TlgLog:
    """Inside `with`, every TlgDecoder.decode_ilabel_rows is logged: the
    decoder's id, its label rows and its two best (text, cost), taken in
    the one n-best call the decode makes."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from asr2pass_tpu_torch.decode.tlg import TlgDecoder

        self._orig = TlgDecoder.decode_ilabel_rows
        calls = self.calls

        def logged(dec, rows):
            dec.accept_ilabel_rows(rows)
            res = dec.nbest(2)
            calls.append({"dec": id(dec), "rows": rows.copy(),
                          "nbest": res})
            return res[0][0] if res else ""

        TlgDecoder.decode_ilabel_rows = logged
        return self

    def __exit__(self, *exc):
        from asr2pass_tpu_torch.decode.tlg import TlgDecoder

        TlgDecoder.decode_ilabel_rows = self._orig


def tlg_decision(a: dict, b: dict) -> dict:
    """Two TLG decodes of one segment (TlgLog entries): their best texts,
    the cost gap to each one's second best, and how far the rows differ.
    A path's cost sums one -log-prob a row, so no two paths can swap
    places between the two decodes unless their gap in one of them is at
    most `tie_bound`, twice the sum over rows of the rows' largest
    difference."""
    import numpy as np

    def gap(c):
        nb = c["nbest"]
        return nb[1][1] - nb[0][1] if len(nb) > 1 else float("inf")

    out = {"texts": [a["nbest"][0][0] if a["nbest"] else "",
                     b["nbest"][0][0] if b["nbest"] else ""],
           "second": [a["nbest"][1][0] if len(a["nbest"]) > 1 else None,
                      b["nbest"][1][0] if len(b["nbest"]) > 1 else None],
           "gaps": [gap(a), gap(b)]}
    ra, rb = a["rows"], b["rows"]
    if ra.shape != rb.shape:
        out["rows"] = [list(ra.shape), list(rb.shape)]
        out["tie_bound"] = None
        return out
    diff = np.abs(ra.astype(np.float64) - rb)
    out["rows_max_abs_diff"] = float(diff.max()) if diff.size else 0.0
    out["tie_bound"] = 2.0 * float(diff.max(axis=1).sum()) if diff.size \
        else 0.0
    top_a, top_b = np.sort(ra, -1)[:, -2:], np.sort(rb, -1)[:, -2:]
    flips = np.nonzero(ra.argmax(-1) != rb.argmax(-1))[0]
    out["argmax_flips"] = [
        [int(t), float(top_a[t, 1] - top_a[t, 0]),
         float(top_b[t, 1] - top_b[t, 0])] for t in flips]
    out["min_top2_margin"] = [float((top_a[:, 1] - top_a[:, 0]).min()),
                              float((top_b[:, 1] - top_b[:, 0]).min())]
    return out


def finals_agree(got, want, e_calls, s_calls):
    """(agree, why) for one connection's finals `got` against a session's
    `want`, with the TLG decodes (TlgLog entries) that made them. Equal
    non-empty lists agree. Otherwise each final that differs must come
    from a near-tie: the two runs' best TLG texts are each other's second
    best, and their two cost gaps sum to at most the bound that the rows'
    difference allows (tlg_decision's tie_bound), so rounding alone could
    swap them."""
    if got == want:
        return bool(got), "equal" if got else "no finals"
    if not (len(got) == len(want) == len(e_calls) == len(s_calls)):
        return False, (f"{len(got)} / {len(want)} finals, {len(e_calls)} / "
                       f"{len(s_calls)} TLG decodes")
    for k, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        d = tlg_decision(e_calls[k], s_calls[k])
        (te, ts), (se, ss) = d["texts"], d["second"]
        if not (d["tie_bound"] is not None and te != ts and se == ts
                and ss == te and sum(d["gaps"]) <= d["tie_bound"]):
            return False, f"segment {k} is no near-tie"
    return True, "every differing final a near-tie"


def lm_server_phase(tmp: str, lm_setup: dict, card: str):
    """10c: the launcher with --engine --engine-capacity 128 --lm-dir (the
    per-token TLG dir) --itn-dir (the toy grammars) on phase 3's and
    phase 7's dirs: P10C_CONNECTIONS paced 2pass connections, every other
    one with hotwords, and a 60 s offline upload. Returns (launches,
    numbers)."""
    from asr2pass_tpu_torch.decode.tlg import TlgDecoder
    from asr2pass_tpu_torch.frontend.audio import load_pcm_bytes
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.server.run_server import build_models, parser
    from asr2pass_tpu_torch.text.itn import FstITN

    t0 = time.perf_counter()
    args = parser().parse_args([
        "--model-dir", os.path.join(tmp, "model"),
        "--online-model-dir", os.path.join(tmp, "online"),
        "--vad-dir", os.path.join(tmp, "vad"),
        "--punc-dir", os.path.join(tmp, "punc"),
        "--lm-dir", lm_setup["dirs"]["tlg"],
        "--itn-dir", lm_setup["dirs"]["itn"],
        "--engine", "--engine-capacity", str(ENGINE_CAPACITY),
        "--host", "127.0.0.1", "--port", "0"])
    with CLOCK.part("build"):
        models = build_models(args)
    if not isinstance(models.itn, FstITN) or models.tlg_dir is None:
        fail("lm: 10c build_models did not wire --lm-dir and --itn-dir")
    print(f"lm: 10c models with --lm-dir (TLG) and --itn-dir loaded "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    hots = [lm_hotwords(lm_setup, i) if i % 2 == 0 else None
            for i in range(P10C_CONNECTIONS)]
    firsts = [lambda name, h=h: reference_first_message(
        "2pass", name, hotwords=json.dumps(h) if h else "")
        for h in hots]
    tlg_log = TlgLog()
    with tlg_log:
        clients, streams, rec, launches, offline, numbers = p9_server(
            models, args, "10c", firsts, card)
    fcfg = models.asr_cfg.frontend
    for i, ((_, msgs), (_, spans)) in enumerate(zip(clients, streams)):
        check_stream(f"c{i}", msgs, spans, rec["segs"].get(f"c{i}", []),
                     fcfg)
    # one TlgDecoder per connection over the one shared graph, biased
    # exactly for the hotworded connections
    by_conn = {}
    for name, dec in rec["lms"]:
        by_conn.setdefault(name, set()).add(dec)
    graph = models._tlg_graphs["asr"]
    decs = {n: next(iter(d)) for n, d in by_conn.items() if len(d) == 1}
    ok = (len(decs) == P10C_CONNECTIONS
          and len({id(d) for d in decs.values()}) == P10C_CONNECTIONS
          and all(isinstance(d, TlgDecoder) and d.graph is graph
                  and (d._bias is not None) == (hots[int(n[1:])] is not None)
                  for n, d in decs.items()))
    print(f"lm: 10c decoders: {len(decs)} connections, "
          f"{len({id(d) for d in decs.values()})} TlgDecoders over one "
          f"graph, biased for the {sum(h is not None for h in hots)} "
          f"hotworded: {ok}", flush=True)
    if not ok:
        fail(f"lm: 10c the engine's LM decoders are not one per connection "
             f"over the shared graph: {by_conn}")
    # every connection's finals against a session with the same LM and
    # hotwords on the automaton's chunks
    def session_finals(i, hotwords, lm=True):
        sess = models.create_session(
            mode="offline", vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000,
            use_itn=True, hotwords=hotwords)
        if not lm:
            models.release_lm_decoder(sess.offline_asr.lm_decoder)
            sess.offline_asr.lm_decoder = None
        with tlg_log:
            n0 = len(tlg_log.calls)
            texts = [r.final_text for r in (
                sess.feed(samples, fin) for samples, fin, _
                in rec["vad_by"].get(f"c{i}", [])) if r.final_text]
        return texts, tlg_log.calls[n0:]

    def engine_finals(i):
        return ([m["text"] for _, m in clients[i][1]
                 if m["mode"] == "2pass-offline"],
                [c for c in tlg_log.calls if c["dec"] == id(decs[f"c{i}"])])

    # every connection's finals against a session with the same LM and
    # hotwords on the automaton's chunks. The engine decodes pass 2 in
    # batches with other connections' segments, the session alone, so the
    # TLG rows differ in their last bits (other cuBLAS tilings; ~1e-5 on
    # an H100); where the two best paths of a segment are that close (an
    # exact tie in the session against 6e-5 in the engine, with a bound
    # of 9e-4, in one draw of the weights), the two runs may pick either.
    # finals_agree accepts such a swap and nothing else; the controls
    # below, the same sessions without the LM or without the hotwords,
    # must fail it
    same, near = 0, []
    for i in range(len(clients)):
        got, e_calls = engine_finals(i)
        want, s_calls = session_finals(i, hots[i])
        ok, why = finals_agree(got, want, e_calls, s_calls)
        same += ok
        if got != want:
            near += [f"c{i}"] if ok else []
            print(f"lm: 10c c{i}'s finals differ from the session's "
                  f"({'a near-tie: ' if ok else ''}{why}):\n  engine  {got}"
                  f"\n  session {want}", flush=True)
            for k, (e, s_) in enumerate(zip(e_calls, s_calls)):
                print(f"lm: 10c c{i} segment {k}: "
                      f"{json.dumps(tlg_decision(e, s_), ensure_ascii=False)}",
                      flush=True)
    controls = {}
    for i, hw, lm in ((0, hots[0], False), (0, None, True),
                      (2, None, True)):
        got, e_calls = engine_finals(i)
        want, s_calls = session_finals(i, hw, lm)
        controls[f"c{i}_lm_{lm}_hotwords_{hw is not None}"] = finals_agree(
            got, want, e_calls, s_calls)[0]
    print(f"lm: 10c controls, the gate on sessions without the LM or the "
          f"hotwords (must all fail): {controls}", flush=True)
    if any(controls.values()):
        fail(f"lm: 10c the finals gate passes a control: {controls}")
    finals = [m["text"] for _, msgs in clients for _, m in msgs
              if m["mode"] == "2pass-offline"]
    text = "".join(finals)
    rewrite = lm_setup["rewrite"]
    itn_ok = (bool(set(text) & set(rewrite.values()))
              and not set(text) & set(rewrite))
    calls = numbers["native_calls"]
    n_seg = len(rec["pairs"])
    print(f"lm: 10c finals agree with a create_session session's with the "
          f"same LM and hotwords for {same} of {P10C_CONNECTIONS} connections "
          f"(near-ties {near}); the "
          f"FST ITN rewrote the grammar's units to digits in the finals: "
          f"{itn_ok}; native calls {calls} for {n_seg} pass-2 segments and "
          f"{len(finals)} finals", flush=True)
    if (same != P10C_CONNECTIONS or not itn_ok
            or calls["tlg_nbest"] != n_seg
            or calls["fst_transduce"] != 2 * sum(bool(f) for f in finals)):
        fail("lm: 10c the finals, the ITN or the native calls fail their "
             "gates")
    want = sum(50 + (16 if t // 2 + 8 >= 256 else 0)
               for _, t in rec["fwd"] if t >= 256)
    got = launches["mh_flash_attention"]["float32"]
    if want == 0 or got != want:
        fail(f"lm: 10c launched {launches}, expected mh_flash_attention "
             f"{want} times in float32")
    ms = [m for _, m in offline]
    ref = models.create_offline_recognizer(
        vad_tail_sil=VAD_TAIL_SIL_MS, vad_max_len=20000).transcribe(
        load_pcm_bytes(s16_bytes(synth_audio(60.0, 1))), use_itn=True)
    if (len(ms) != 1 or ms[0]["mode"] != "offline"
            or ms[0]["text"] != ref.text or not ref.text):
        fail(f"lm: 10c offline upload gave {ms}, transcribe gives "
             f"{ref.text!r}")
    # FstITN.normalize per final, on the finals' pre-ITN text (the
    # session's, ITN off)
    itn = models.itn
    sess = models.create_session(mode="offline",
                                 vad_tail_sil=VAD_TAIL_SIL_MS,
                                 vad_max_len=20000, use_itn=False)
    raw = [r.final_text for r in (sess.feed(samples, fin) for samples, fin, _
                                  in rec["vad_by"]["c1"]) if r.final_text]
    nb.reset_call_counts()
    _, itn_ms = host_ms(lambda: [itn.normalize(t) for t in raw],
                        LM_TIMING_REPS)
    numbers["itn_ms_per_final"] = itn_ms / max(len(raw), 1)
    numbers["itn_chars_per_final"] = sum(map(len, raw)) / max(len(raw), 1)
    print(f"native: FstITN.normalize {numbers['itn_ms_per_final']:.2f} ms a "
          f"final ({numbers['itn_chars_per_final']:.0f} chars) on {card}; "
          f"10c partial p50/p95 {numbers['partial_ms_p50']:.1f} / "
          f"{numbers['partial_ms_p95']:.1f} ms, final p50/p95 "
          f"{numbers['final_ms_p50']:.1f} / {numbers['final_ms_p95']:.1f} "
          f"ms, p2_recognize {numbers['stages'].get('p2_recognize')}, "
          f"p2_postprocess {numbers['stages'].get('p2_postprocess')} "
          f"(p50, p95 ms, count)", flush=True)
    numbers.update(finals_eq_session=same, finals_near_ties=near,
                   itn_rewrote=itn_ok)
    print(f"server: 10c {json.dumps(numbers)}", flush=True)
    print(f"lm: 10c {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, numbers


def phase10(tmp: str, card: str):
    """Phase 10. Returns ({path: launches}, {sub-phase: numbers})."""
    with CLOCK.part("build"):
        lm_setup = lm_phase_dirs(os.path.join(tmp, "lm10"),
                                 cjk_tokens(P10_VOCAB), card)
    with CLOCK.phase("10a"):
        l_off, n_off = lm_offline_phase(os.path.join(tmp, "model"),
                                        lm_setup, card)
    with CLOCK.phase("10b"):
        l_svs, n_svs = lm_svs_phase(os.path.join(tmp, "svs"), lm_setup,
                                    card)
    with CLOCK.phase("10c"):
        l_srv, n_srv = lm_server_phase(tmp, lm_setup, card)
    return ({"lm_offline": l_off, "lm_svs": l_svs, "lm_engine": l_srv},
            {"lm": lm_setup["numbers"], "10a": n_off, "10b": n_svs,
             "10c": n_srv})


# ---------------------------------------------------------------------------
# phase 11: int8 Paraformer, the fine-tune step, the offline tools
# ---------------------------------------------------------------------------

# 11a: card vs CPU of the int8 recognizer in fp32 on one 15 s segment.
# w8a16 keeps fp32 activations: the limit is phase 4's (CPU_TOL of the
# logits' range). w8a8 rounds each dense layer's input rows to 1/127 of
# their max: a card/CPU difference of one fp32 ulp upstream can round an
# element to the other int8 step, one draw of the rounding error again,
# which later layers carry on. So the w8a8 logits are held to within
# w8a8's own error against the float model on the same segment (a share
# of at most INT8_SHARE_OF_QUANT_ERROR; 0-0.64 of it over 12 seeds of
# paraformer_tiny against the JAX package on the CPU). It cannot be
# tighter: the flips are fresh draws of w8a8's own rounding error, so a
# w8a16 forward in w8a8's place lands as near, and this gate does not tell
# the two apart. The per-layer gate does: one w8a8 call of each (rows,
# d_in, d_out) of the card's forward (the last, whose input is an
# activation of the forward; a BLSTM's first step takes zeros), again on
# the card and on the CPU with the same input and weights. The steps
# around the exact int8 product are the same IEEE operations on both
# (utils.div_127 keeps the card's division by 127 a true one), so the
# outputs should be equal; they are held to W8A8_LAYER_ULPS fp32 ulps of
# the output's largest magnitude, and the same layer's w8a16 product on
# the card (the activation quantization left out) must fall outside that
INT8_SHARE_OF_QUANT_ERROR = 1.0
W8A8_LAYER_ULPS = 4
INT8_ITERS = 3
# 11b: the fine-tune
P11_TRAIN_B = 8
P11_TRAIN_T = 250          # 15 s of LFR frames, below the kernels' MIN_T
P11_TRAIN_U = 60
P11_TRAIN_STEPS = 20
# one step at B=2, card vs CPU: fp32 sums in other orders over 50 + 16
# blocks. The rescaled alphas reach each utterance's last CIF fire exactly
# at the threshold, so there the card and the CPU may round to different
# sides and one token's embedding becomes zero on one of them; the
# comparison runs with the threshold 1e-4 lower, which fires it on both
# (every other crossing is far from it). Loss within TRAIN_LOSS_RTOL,
# each parameter's gradient norm within TRAIN_GRAD_RTOL of the CPU's
# (gradient norms of the tensors the loss reaches, the smallest held
# against 1e-3 of the largest; the others get no gradient)
P11_CPU_THRESHOLD_SHIFT = 1e-4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# 11c: the offline tools
P11_WAVS = ((10.0, 16000), (12.0, 16000), (8.0, 8000), (15.0, 16000))
P11_ALIGN_PAIRS = 1000


def int_mm_gate(shapes: dict) -> dict:
    """Every (m, k, n) that went through torch._int_mm on the path, again
    on seeded int8 operands: the card's padded product equals the CPU's
    exactly (the CPU's int32 product taken in float64, exact for these
    sums, which stay far below 2^53)."""
    import torch

    from asr2pass_tpu_torch.ops import int8

    gen = torch.Generator().manual_seed(11)
    padded = 0
    for (m, k, n) in sorted(shapes):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
        got = int8.int_mm_padded(a.cuda(), int8.pad_weight(b.cuda()),
                                 n).cpu()
        ref = (a.double() @ b.double()).to(torch.int32)
        if not torch.equal(got, ref):
            fail(f"int8: _int_mm at {(m, k, n)} differs from the CPU's "
                 "int32 product")
        padded += int8.int_mm_shape(m, k, n) != (m, k, n)
    print(f"int8: {len(shapes)} _int_mm shapes on the path ({padded} "
          f"padded) equal the CPU's int32 product exactly: "
          f"{sorted(shapes)}", flush=True)
    return {"shapes": len(shapes), "padded": padded}


@contextlib.contextmanager
def w8a8_calls():
    """Record, through each models module's reference to layers.dense, the
    last w8a8 call of each (rows, d_in, d_out): {shape: (layer, input)}."""
    from asr2pass_tpu_torch.models import layers

    orig = layers.dense
    calls = {}

    def recording(p, x):
        if p.weight_key == "w_q":
            calls[(x.numel() // x.shape[-1], *p.w_q.shape)] = (p, x.clone())
        return orig(p, x)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("asr2pass_tpu_torch.models")
            and getattr(m, "dense", None) is orig]
    for m in mods:
        m.dense = recording
    try:
        yield calls
    finally:
        for m in mods:
            m.dense = orig


def w8a8_layer_gate(calls: dict) -> dict:
    """Each recorded w8a8 call again on the card and on the CPU, and the
    same layer's w8a16 product on the card as the control (the comment at
    W8A8_LAYER_ULPS)."""
    import copy

    import torch

    from asr2pass_tpu_torch.models.layers import dense

    eps = torch.finfo(torch.float32).eps
    exact = 0
    worst = 0.0
    nearest_control = float("inf")
    for shape, (layer, x) in sorted(calls.items()):
        with torch.inference_mode():
            got = dense(layer, x).cpu()
            with CLOCK.part("cpu"):
                ref = dense(copy.deepcopy(layer).cpu(), x.cpu())
            control = (x @ layer.w_q.to(x.dtype)) * layer.scale.to(x.dtype)
            if layer.b is not None:
                control = control + layer.b.to(x.dtype)
        limit = W8A8_LAYER_ULPS * eps * ref.abs().max().item()
        err = (got - ref).abs().max().item()
        control_err = (control.cpu() - ref).abs().max().item()
        exact += torch.equal(got, ref)
        worst = max(worst, err / max(limit, 1e-30))
        nearest_control = min(nearest_control,
                              control_err / max(limit, 1e-30))
        if not err <= limit:
            fail(f"int8: w8a8 layer {shape} card vs cpu {err:.3e} > "
                 f"{limit:.3e}")
        if not control_err > limit:
            fail(f"int8: at {shape} a w8a16 product reads {control_err:.3e}"
                 f" of the CPU's w8a8, within the limit {limit:.3e}: the "
                 "gate cannot tell the forms apart")
    print(f"int8: {len(calls)} w8a8 layer shapes of the 15 s forward, card "
          f"vs cpu on the same input: {exact} bit-equal, worst "
          f"{worst:.3f} of the limit ({W8A8_LAYER_ULPS} ulps of the range); "
          f"w8a16 in their place at least {nearest_control:.3e} of it",
          flush=True)
    if len(calls) < 8:
        fail(f"int8: only {len(calls)} w8a8 layer shapes recorded")
    return {"shapes": len(calls), "bit_equal": exact,
            "worst_share_of_limit": worst,
            "control_min_share_of_limit": nearest_control}


def int_mm_table(card: str) -> list:
    """torch._int_mm (the path's column-major weight, and a row-major one)
    against bf16 and fp32 (TF32 off) products at the encoder's shapes, M =
    16000 rows (16 x 1000 frames): ms each (CUDA events, back to back)
    and the rate."""
    import torch

    from asr2pass_tpu_torch.ops import int8

    rows = []
    for k, n in ((512, 1536), (512, 2048), (2048, 512)):
        m = 16000
        a8 = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                           device="cuda")
        b8 = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                           device="cuda")
        a16, b16 = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
        a32, b32 = a8.float(), b8.float()
        b8c = int8.column_major(b8)
        row = {"m": m, "k": k, "n": n,
               "int_mm_ms": time_ms(lambda: int8.int_mm_padded(a8, b8c), 50),
               "int_mm_row_major_ms": time_ms(
                   lambda: torch._int_mm(a8, b8), 50),
               "bf16_ms": time_ms(lambda: a16 @ b16, 50),
               "fp32_ms": time_ms(lambda: a32 @ b32, 20)}
        ops = 2.0 * m * k * n
        row.update({f"{key[:-3]}_tops": ops / row[key] / 1e9
                    for key in ("int_mm_ms", "int_mm_row_major_ms",
                                "bf16_ms", "fp32_ms")})
        rows.append(row)
        print(f"int8: product {m}x{k}x{n}: _int_mm {row['int_mm_ms']:.4f} "
              f"ms ({row['int_mm_tops']:.0f} TOP/s; row-major weight "
              f"{row['int_mm_row_major_ms']:.4f} ms), bf16 "
              f"{row['bf16_ms']:.4f} ms ({row['bf16_tops']:.0f}), fp32 "
              f"{row['fp32_ms']:.4f} ms ({row['fp32_tops']:.0f}) on {card}",
              flush=True)
    return rows


def int8_phase(model_dir: str, gen, card: str):
    """11a. Returns ({path: {entry point: {dtype: launches}}}, numbers)."""
    import torch

    from asr2pass_tpu_torch.config import paraformer_large
    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.models.layers import Dense, dense
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.ops import int8
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.utils import cast_floats, quantize_params

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        bundle = load_offline_bundle(model_dir)
        cfg = paraformer_large()                    # bench.py's: no bicif head
        fcfg = cfg.frontend
        sd16 = cast_floats(bundle.params, torch.bfloat16)
        # phase 5's weights (the dir's, with the bicif head, which bench.py's
        # configuration does not run)
        models = {"bf16": paraformer.from_state_dict(sd16, bundle.cfg, "cuda"),
                  "w8a8": paraformer.from_state_dict(
                      quantize_params(sd16), bundle.cfg, "cuda"),
                  "w8a16": paraformer.from_state_dict(
                      quantize_params(sd16, weight_only=True), bundle.cfg,
                      "cuda")}
    qkv = models["w8a8"].encoder.rest[0].att.qkv
    if qkv.weight.dtype != torch.int8 or qkv.scale.dtype != torch.bfloat16:
        fail("int8: quantize_params after the bf16 cast did not give int8 "
             "weights with bf16 scales")
    t_b = int(60.0 * 1000 / (fcfg.frame_shift_ms * fcfg.lfr_n))
    feats16 = torch.randn(16, t_b, fcfg.lfr_dim, generator=gen,
                          device="cuda").to(torch.bfloat16)
    lens16 = torch.full((16,), t_b, dtype=torch.long, device="cuda")

    def forward(model, feats=feats16, lens=lens16):
        with torch.inference_mode():
            out = paraformer.apply(model, cfg, feats, lens,
                                   max_tokens=feats.shape[1] // 2 + 8)
            if not torch.isfinite(out.logits).all():
                fail(f"int8 forward {tuple(feats.shape)}: non-finite logits")
            return paraformer.greedy_ids(out)

    numbers = {"card": card, "forward": {}}
    launches = {}
    shapes = {}
    ids = {}
    for form, model in models.items():
        torch.cuda.synchronize()
        att.reset_launch_counts()
        int8.reset_launch_counts()
        got_ids, n_tok = forward(model)
        torch.cuda.synchronize()
        counts = att.launch_counts_by_dtype()
        got = {k: v["bfloat16"] for k, v in counts.items()}
        if got["mh_flash_attention"] != 66 or sum(got.values()) != 66 or \
                any(v["float32"] for v in counts.values()):
            fail(f"int8: {form} forward B=16 T={t_b} launched {counts}, "
                 "expected mh_flash_attention 66 times in bfloat16 only")
        n_mm = sum(int8.launch_shapes().values())
        if (n_mm > 0) != (form == "w8a8"):
            fail(f"int8: {form} forward made {n_mm} _int_mm calls")
        for shape, n in int8.launch_shapes().items():
            shapes[shape] = shapes.get(shape, 0) + n
        ids[form] = (got_ids.cpu(), n_tok.cpu())
        launches[form] = counts
        t1 = time.perf_counter()
        for _ in range(INT8_ITERS):
            forward(model)
        fwd_s = (time.perf_counter() - t1) / INT8_ITERS
        prof = device_profile(lambda: forward(model),
                              f"int8: {form} forward B=16 T={t_b}",
                              host_ops=False)
        numbers["forward"][form] = {
            "ms": fwd_s * 1e3, "audio_s_per_s": 16 * 60.0 / fwd_s,
            "idle_share": (None if prof["busy_ms"] is None
                           else 1 - prof["busy_ms"] / prof["wall_ms"]),
            "busy_ms": prof["busy_ms"], "int_mm_calls": n_mm}
        print(f"int8: {form} forward B=16 T={t_b}: {fwd_s * 1e3:.1f} ms, "
              f"{16 * 60.0 / fwd_s:.1f} audio-s/s on {card}; _int_mm calls "
              f"{n_mm}", flush=True)
    ref_ids, ref_n = ids["bf16"]
    for form in ("w8a8", "w8a16"):
        got_ids, got_n = ids[form]
        same = total = 0
        for b in range(16):
            n = int(min(ref_n[b], got_n[b]))
            same += int((got_ids[b, :n] == ref_ids[b, :n]).sum())
            total += n
        agree = same / max(total, 1)
        numbers["forward"][form]["ids_agree_with_bf16"] = agree
        numbers["forward"][form]["token_num_equal_bf16"] = int(
            (got_n == ref_n).sum())
        print(f"int8: {form} greedy ids agree with bf16 at {agree:.4f} of "
              f"{total} tokens; token_num equal in "
              f"{int((got_n == ref_n).sum())} of 16 rows", flush=True)
    # the split-head entry points under w8a8
    for b_, t_, entry in ((2, 3072, "_attention_ss"),
                          (2, 5120, "_attention_flash")):
        feats = torch.randn(b_, t_, fcfg.lfr_dim, generator=gen,
                            device="cuda").to(torch.bfloat16)
        lens = torch.tensor([t_, t_ * 3 // 5], device="cuda")
        torch.cuda.synchronize()
        att.reset_launch_counts()
        int8.reset_launch_counts()
        forward(models["w8a8"], feats, lens)
        torch.cuda.synchronize()
        counts = att.launch_counts_by_dtype()
        got = {k: v["bfloat16"] for k, v in counts.items()}
        print(f"int8: w8a8 forward B={b_} T={t_}: kernel launches {counts}",
              flush=True)
        if got[entry] != 50 or sum(got.values()) != 50 or any(
                v["float32"] for v in counts.values()):
            fail(f"int8: w8a8 forward B={b_} T={t_} launched {counts}, "
                 f"expected {entry} 50 times in bfloat16 only")
        for shape, n in int8.launch_shapes().items():
            shapes[shape] = shapes.get(shape, 0) + n
        launches[f"w8a8_T{t_}"] = counts
    del models, feats16
    torch.cuda.empty_cache()
    numbers["products"] = int_mm_table(card)
    # one dense layer of the encoder's FFN at the bench shape: the w8a8
    # route (row scales, quantize, _int_mm, rescale) against bf16
    layer = Dense(512, 2048, generator=gen, device="cuda")
    x = torch.randn(16, t_b, 512, generator=gen, device="cuda").to(
        torch.bfloat16)
    dense_ms = {}
    with torch.inference_mode():
        cast_floats(layer, torch.bfloat16)
        dense_ms["bf16"] = time_ms(lambda: dense(layer, x), 50)
        layer.quantize_(weight_only=True)
        dense_ms["w8a16"] = time_ms(lambda: dense(layer, x), 50)
        layer8 = Dense(512, 2048, generator=gen, device="cuda")
        cast_floats(layer8, torch.bfloat16)
        layer8.quantize_()
        dense_ms["w8a8"] = time_ms(lambda: dense(layer8, x), 50)
    numbers["dense_512x2048_ms"] = dense_ms
    print(f"int8: one dense 16000x512x2048 (bf16 activations): "
          f"{json.dumps(dense_ms)} on {card}", flush=True)

    # the timestamp recognizer quantized (w8a8, fp32 activations)
    asr = ParaformerOffline(quantize_params(bundle.params), bundle.cfg,
                            bundle.vocab, cmvn=bundle.cmvn)
    if asr.model.predictor.blstm["fw"].wh.weight.dtype != torch.int8 or \
            asr.model.predictor.us_cnn.w.dtype != torch.float32:
        fail("int8: the timestamp head is not quantized as specified")
    batch = [synth_audio(60.0, 100 + i) for i in range(16)]
    att.reset_launch_counts()
    int8.reset_launch_counts()
    outs = asr.recognize_batch(batch)
    torch.cuda.synchronize()
    counts = att.launch_counts_by_dtype()
    for shape, n in int8.launch_shapes().items():
        shapes[shape] = shapes.get(shape, 0) + n
    if counts["mh_flash_attention"]["float32"] != 66 or any(
            not text or not stamps for text, stamps in outs):
        fail(f"int8: w8a8 recognize_batch 16 x 60 s: launches {counts}, "
             "or an empty text or timestamps")
    launches["w8a8_recognizer"] = counts
    t1 = time.perf_counter()
    for _ in range(2):
        asr.recognize_batch(batch)
    rec_s = (time.perf_counter() - t1) / 2
    numbers["recognize_batch_w8a8_fp32"] = {
        "ms": rec_s * 1e3, "audio_s_per_s": 16 * 60.0 / rec_s}
    print(f"int8: recognize_batch 16 x 60 s, timestamp model w8a8 fp32: "
          f"{rec_s * 1e3:.1f} ms, {16 * 60.0 / rec_s:.1f} audio-s/s on "
          f"{card}", flush=True)
    numbers["int_mm"] = int_mm_gate(shapes)
    del batch

    # card vs CPU on one 15 s segment, fp32, both int8 forms
    seg = synth_audio(15.0, 4)
    n_mel = 1 + (len(seg) - fcfg.frame_length) // fcfg.frame_shift
    t_lfr = -(-n_mel // fcfg.lfr_n)

    def segment(rec_, device):
        feats = offline_frontend_device([seg], [n_mel], 256, fcfg,
                                        *bundle.cmvn, batch_b=1,
                                        device=device)
        with torch.inference_mode():
            out = rec_._forward(feats, [t_lfr])
        return int(out.token_num[0]), out.logits[0].cpu()

    n_f, logits_f = segment(ParaformerOffline(
        bundle.params, bundle.cfg, bundle.vocab, cmvn=bundle.cmvn), "cuda")
    numbers["cpu"] = {}
    for form, weight_only in (("w8a8", False), ("w8a16", True)):
        sd = quantize_params(bundle.params, weight_only=weight_only)
        with w8a8_calls() as calls:
            n_g, lg = segment(ParaformerOffline(sd, bundle.cfg, bundle.vocab,
                                                cmvn=bundle.cmvn), "cuda")
        if not weight_only:
            numbers["w8a8_layers"] = w8a8_layer_gate(calls)
        del calls
        with CLOCK.part("cpu"):
            n_c, lc = segment(ParaformerOffline(sd, bundle.cfg, bundle.vocab,
                                                cmvn=bundle.cmvn, device="cpu"),
                              "cpu")
        err = ((lg[:n_c] - lc[:n_c]).abs().max().item() if n_g == n_c
               else float("inf"))
        n = min(n_c, n_f)
        quant_err = (lc[:n] - logits_f[:n]).abs().max().item()
        limit = (INT8_SHARE_OF_QUANT_ERROR * quant_err if not weight_only
                 else CPU_TOL * max(1.0, lc[:n_c].abs().max().item()))
        numbers["cpu"][form] = {"token_num_card": n_g, "token_num_cpu": n_c,
                                "max_abs_err": err, "limit": limit,
                                "quant_err_vs_fp32": quant_err}
        print(f"int8: {form} 15 s segment T={t_lfr} card vs cpu: token_num "
              f"{n_g} / {n_c}; max |logits card - cpu| {err:.3e} (limit "
              f"{limit:.3e}; {form}'s own error against fp32 "
              f"{quant_err:.3e})", flush=True)
        if n_g != n_c or not err <= limit:
            fail(f"int8: {form} card vs cpu: token_num {n_g} / {n_c}, "
                 f"logits {err:.3e} against {limit:.3e}")
    numbers["s"] = time.perf_counter() - t0
    return launches, numbers


def finetune_phase(model_dir: str, tmp: str, card: str):
    """11b. Returns numbers."""
    import dataclasses

    import numpy as np
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.train import checkpoint, train

    t0 = time.perf_counter()
    with CLOCK.part("build"):
        bundle = load_offline_bundle(model_dir)
    cfg = bundle.cfg
    d = cfg.frontend.lfr_dim
    rng = np.random.default_rng(11)
    # 256 frames, so that the refusal below can take a batch at MIN_T
    feats = torch.from_numpy(rng.standard_normal(
        (P11_TRAIN_B, 256, d)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(
        4, cfg.vocab_size, (P11_TRAIN_B, P11_TRAIN_U)))

    def batch(b, device, t_len=P11_TRAIN_T):
        return train.TrainBatch(
            feats=feats[:b, :t_len].to(device),
            feat_lens=torch.full((b,), t_len, device=device),
            targets=targets[:b].to(device),
            target_lens=torch.full((b,), P11_TRAIN_U, device=device))

    def fresh(device):
        model = paraformer.from_state_dict(bundle.params, cfg, device)
        return model, train.make_optimizer(model)

    numbers = {"card": card}
    # card vs CPU: one loss and backward at B=2, threshold 1e-4 lower
    cmp_cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor,
        threshold=cfg.predictor.threshold - P11_CPU_THRESHOLD_SHIFT))
    res = {}
    for device in ("cuda", "cpu"):
        with CLOCK.part(on_cpu(device)):
            model, _ = fresh(device)
            loss, _ = train.loss_fn(model, cmp_cfg, batch(2, device))
            loss.backward()
            res[device] = (loss.item(), {
                n: p.grad.norm().item() for n, p in model.named_parameters()
                if p.grad is not None})
            del model, loss
    (l_g, g_g), (l_c, g_c) = res["cuda"], res["cpu"]
    if g_g.keys() != g_c.keys():
        fail("finetune: card and cpu give gradients to different tensors")
    loss_err = abs(l_g - l_c) / abs(l_c)
    # a norm far below the largest one is held to TRAIN_GRAD_RTOL of
    # 1e-3 of the largest (its rounding is that of the sums it feeds)
    floor = 1e-3 * max(g_c.values())
    errs = {n: abs(g_g[n] - g_c[n]) / max(g_c[n], floor) for n in g_c}
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    numbers["card_vs_cpu"] = {"loss_card": l_g, "loss_cpu": l_c,
                              "loss_rel_err": loss_err,
                              "grad_norm_max_rel_err": grad_err,
                              "grad_norm_worst": worst,
                              "tensors": len(g_c)}
    print(f"finetune: B=2 T={P11_TRAIN_T} card vs cpu: loss {l_g:.6f} / "
          f"{l_c:.6f} (rel {loss_err:.2e}, limit {TRAIN_LOSS_RTOL}); "
          f"{len(g_c)} gradient norms, max rel err {grad_err:.2e} at "
          f"{worst} (norm {g_c[worst]:.3e}, largest {max(g_c.values()):.3e}; "
          f"limit {TRAIN_GRAD_RTOL})", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL):
        fail("finetune: card and cpu disagree on the loss or the gradients")

    # 20 steps on one batch of B=8 x 15 s
    model, opt = fresh("cuda")
    tb = batch(P11_TRAIN_B, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    losses = []
    ck = os.path.join(tmp, "ck11")
    t1 = time.perf_counter()
    for i in range(P11_TRAIN_STEPS):
        m = train.train_step(model, opt, tb, cfg)
        losses.append(m["loss"].item())
        if i == 0:
            t_ck = time.perf_counter()
            checkpoint.save_checkpoint(ck, model, opt, step=1)
            t1 += time.perf_counter() - t_ck
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / P11_TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    if any(att.launch_counts().values()):
        fail(f"finetune: a CUDA attention kernel ran under autograd: "
             f"{att.launch_counts()}")
    # the loss must fall, as tests/test_parallel.py asks of the JAX step;
    # at this lr the quantity loss swings from step to step on random
    # weights (65.9 -> 110.9 -> 8.7 in one run), so the last five steps'
    # mean is held below the first step's loss
    if not (all(np.isfinite(losses))
            and np.mean(losses[-5:]) < losses[0]):
        fail(f"finetune: the loss did not fall over {P11_TRAIN_STEPS} "
             f"steps: {losses}")
    numbers.update({
        "losses": losses, "step_ms": step_s * 1e3,
        "steps_per_s": 1 / step_s,
        "audio_s_per_s": P11_TRAIN_B * P11_TRAIN_T * 0.06 / step_s,
        "max_memory_allocated_bytes": peak})
    print(f"finetune: paraformer_large(timestamp) fp32, B={P11_TRAIN_B} x "
          f"{P11_TRAIN_T * 0.06:.0f} s, U={P11_TRAIN_U}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in {P11_TRAIN_STEPS} steps "
          f"(last five's mean {np.mean(losses[-5:]):.4f}); "
          f"{step_s * 1e3:.1f} ms a step, {1 / step_s:.2f} steps/s, "
          f"{P11_TRAIN_B * P11_TRAIN_T * 0.06 / step_s:.1f} audio-s/s "
          f"trained; peak {peak / 2**30:.2f} GiB on {card}", flush=True)

    # resume: restore step 1's checkpoint and take step 2 again
    model2 = paraformer.from_state_dict(bundle.params, cfg, "cuda")
    opt2 = train.make_optimizer(model2)
    if checkpoint.restore_checkpoint(ck, model2, opt2) != 1:
        fail("finetune: the checkpoint's step is not 1")
    m2 = train.train_step(model2, opt2, tb, cfg)
    resumed = m2["loss"].item()
    rel = abs(resumed - losses[1]) / abs(losses[1])
    numbers["resume"] = {"step2_loss": losses[1], "resumed_loss": resumed,
                         "rel_err": rel}
    print(f"finetune: resumed from step 1's checkpoint: step 2 loss "
          f"{resumed:.6f} against {losses[1]:.6f} uninterrupted (rel "
          f"{rel:.2e}, limit 1e-6)", flush=True)
    if not rel <= 1e-6:
        fail("finetune: the resumed step 2 differs from the uninterrupted")
    del model, opt, model2, opt2, tb

    # T=256 under autograd reaches the kernel, which refuses
    model, _ = fresh("cuda")
    try:
        train.loss_fn(model, cfg, batch(2, "cuda", t_len=256))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"finetune: T=256 with gradients on raises: {e}", flush=True)
    else:
        fail("finetune: T=256 with gradients on did not raise")
    del model
    torch.cuda.empty_cache()
    numbers["s"] = time.perf_counter() - t0
    return numbers


def tools_phase(model_dir: str, tmp: str, card: str):
    """11c. Returns ({entry point: {dtype: launches}}, numbers)."""
    import argparse
    import asyncio
    import wave as wave_mod

    import numpy as np
    import torch

    from asr2pass_tpu_torch.frontend.audio import load_audio_file
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.server.run_server import build_models, parser
    from asr2pass_tpu_torch.server.ws_server import AsrWsServer
    from asr2pass_tpu_torch.tools import compute_wer, eval_cer
    from asr2pass_tpu_torch.tools.transcribe import build_recognizer

    t0 = time.perf_counter()
    root = os.path.join(tmp, "tools11")
    os.makedirs(root)
    rng = np.random.default_rng(12)
    with open(os.path.join(model_dir, "tokens.json"), encoding="utf-8") as f:
        tokens = json.load(f)
    scp, ref = [], []
    for i, (seconds, fs) in enumerate(P11_WAVS):
        wave = synth_audio(seconds, 200 + i)
        if fs != FS:
            wave = wave[:: FS // fs]
        path = os.path.join(root, f"u{i}.wav")
        with wave_mod.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes((wave * 32767).astype("<i2").tobytes())
        scp.append(f"u{i} {path}")
        ref.append(f"u{i} " + "".join(
            tokens[k] for k in rng.integers(4, len(tokens), 40)))
    scp_path, ref_path = (os.path.join(root, "wav.scp"),
                          os.path.join(root, "text"))
    with open(scp_path, "w", encoding="utf-8") as f:
        f.write("\n".join(scp) + "\n")
    with open(ref_path, "w", encoding="utf-8") as f:
        f.write("\n".join(ref) + "\n")
    numbers = {"card": card}
    att.reset_launch_counts()

    # the transcribe CLI in a process of its own, against transcribe in
    # this one on the same dir
    t1 = time.perf_counter()
    out_dir = os.path.join(root, "out")
    res = subprocess.run(
        [sys.executable, "-m", "asr2pass_tpu_torch.tools.transcribe",
         "--scp", scp_path, "--model-dir", model_dir, "--output-dir",
         out_dir, "--device", "cuda"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if res.returncode != 0:
        fail(f"tools: transcribe CLI exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    numbers["transcribe_cli_s"] = time.perf_counter() - t1
    with open(os.path.join(out_dir, "text"), encoding="utf-8") as f:
        cli = dict(line.rstrip("\n").split("\t", 1) for line in f)
    rec = build_recognizer(argparse.Namespace(
        model_dir=model_dir, svs_dir="", vad_dir="", punc_dir="",
        itn=False))
    if rec.asr.device.type != "cuda":
        fail("tools: build_recognizer did not default to the card")
    for line in scp:
        name, path = line.split()
        want = rec.transcribe(load_audio_file(path, FS)).text
        if not want or cli.get(name) != want:
            fail(f"tools: transcribe CLI {name}: {cli.get(name)!r} against "
                 f"transcribe's {want!r}")
    print(f"tools: transcribe CLI (own process, --device cuda) = "
          f"OfflineRecognizer.transcribe on {len(scp)} files "
          f"({numbers['transcribe_cli_s']:.1f} s) ; {res.stdout.strip()}",
          flush=True)
    del rec

    # eval_cer in-process and --server against the port's server
    def run_eval(extra, tag):
        out = os.path.join(root, f"{tag}.json")
        hyp = os.path.join(root, f"{tag}.hyp")
        t2 = time.perf_counter()
        rc = eval_cer.main(["--scp", scp_path, "--ref", ref_path,
                            "--out", out, "--hyp-out", hyp] + extra)
        if rc != 0:
            fail(f"tools: eval_cer {tag} exited {rc}")
        with open(out, encoding="utf-8") as f:
            rep = json.load(f)
        with open(hyp, encoding="utf-8") as f:
            hyps = f.read()
        numbers[f"eval_cer_{tag}"] = {"cer": rep["cer"],
                                      "errors": rep["errors"],
                                      "s": time.perf_counter() - t2}
        for k in ("wall_s", "audio_s"):
            rep.pop(k)
        return rep, hyps

    rep_ip, hyps_ip = run_eval(["--model-dir", model_dir], "in_process")
    models = build_models(parser().parse_args(
        ["--model-dir", model_dir, "--no-itn"]))
    server = AsrWsServer(models, host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def serve():
        asyncio.set_event_loop(loop)
        srv = loop.run_until_complete(server.serve())
        holder["port"] = srv.sockets[0].getsockname()[1]
        started.set()
        try:
            loop.run_forever()
        finally:
            srv.close()
            loop.run_until_complete(srv.wait_closed())

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    if not started.wait(120):
        fail("tools: the server did not start")
    try:
        rep_srv, hyps_srv = run_eval(
            ["--server", f"ws://127.0.0.1:{holder['port']}"], "server")
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(60)
        server.executor.shutdown(wait=False)
    if th.is_alive():
        fail("tools: the server thread did not stop")
    print(f"tools: eval_cer in-process CER {rep_ip['cer']} "
          f"({rep_ip['errors']}/{rep_ip['ref_len']}), --server CER "
          f"{rep_srv['cer']} ({rep_srv['errors']}/{rep_srv['ref_len']})",
          flush=True)
    if hyps_srv != hyps_ip or rep_srv != rep_ip:
        fail("tools: eval_cer --server and in-process differ")
    launches = att.launch_counts_by_dtype()

    # edit_align: native against the Python DP
    pairs = []
    for _ in range(P11_ALIGN_PAIRS):
        a = [str(k) for k in rng.integers(0, 30, rng.integers(0, 60))]
        b = [str(k) for k in rng.integers(0, 30, rng.integers(0, 60))]
        pairs.append((a, b))
    nb.reset_call_counts()
    native, native_ms = host_ms(
        lambda: [compute_wer.align(a, b) for a, b in pairs], 3)
    plain, plain_ms = host_ms(
        lambda: [compute_wer.align_plain(a, b) for a, b in pairs], 1)
    calls = nb.call_counts()["edit_align"]
    if native != plain or calls != 3 * P11_ALIGN_PAIRS:
        fail(f"tools: native edit_align differs from the Python DP, or "
             f"{calls} native calls")
    numbers["edit_align"] = {"pairs": P11_ALIGN_PAIRS,
                             "native_ms": native_ms, "plain_ms": plain_ms}
    print(f"tools: edit_align on {P11_ALIGN_PAIRS} pairs: native "
          f"{native_ms:.1f} ms, Python DP {plain_ms:.1f} ms, equal ops and "
          f"distances", flush=True)
    numbers["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return launches, numbers


def phase11(tmp: str, gen, card: str):
    """Phase 11. Returns ({path: launches}, {sub-phase: numbers})."""
    model_dir = os.path.join(tmp, "model")
    with CLOCK.phase("11a"):
        l_int8, n_int8 = int8_phase(model_dir, gen, card)
    with CLOCK.phase("11b"):
        n_ft = finetune_phase(model_dir, tmp, card)
    with CLOCK.phase("11c"):
        l_tools, n_tools = tools_phase(model_dir, tmp, card)
    return ({"int8": l_int8["w8a8"], "int8_T3072": l_int8["w8a8_T3072"],
             "int8_T5120": l_int8["w8a8_T5120"],
             "int8_recognizer": l_int8["w8a8_recognizer"],
             "tools": l_tools},
            {"11a": n_int8, "11b": n_ft, "11c": n_tools})


# ---------------------------------------------------------------------------
# phase 12: the FunASR converter with its ONNX reader and executor, model
# provisioning, the data-quality tools
# ---------------------------------------------------------------------------

# the opset of the TorchScript exporter the port's CPU tests export with
# (torch 2.13's default); pinned, so that another torch on the card exports
# the same operators
P12_OPSET = 20
P12_T = 300                # 12a's static export: 300 LFR frames, 18 s
P12_EXEC_TOL = 1e-4        # the executor on the card against the CPU
P12_DNSMOS_TOL = 1e-5
# 12b at full width and reduced depth: the streaming pair's encoder and
# decoder blocks, SenseVoice's encoder and tp blocks
P12_ONLINE_BLOCKS = (6, 3)
P12_SVS_BLOCKS = (6, 2)
# where torch has kept the exporter's onnxscript merge step
_ONNXSCRIPT_FN_MODULES = (
    "torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
    "torch.onnx._internal.onnx_proto_utils")


def onnx_export(module, args, path: str, input_names, output_names) -> list:
    """torch.onnx.export through the TorchScript exporter at P12_OPSET,
    with its onnxscript merge step (`_add_onnxscript_fn`) skipped: the
    graphs have no custom ops and the onnx package may be absent. The
    step's module moved between torch releases; a torch that keeps it in
    none of the known places fails here. Returns the sorted op types of
    the exported graph."""
    import importlib
    import inspect

    import torch

    from asr2pass_tpu_torch.tools.onnx_reader import read_onnx

    mod = None
    for name in _ONNXSCRIPT_FN_MODULES:
        try:
            cand = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(cand, "_add_onnxscript_fn"):
            mod = cand
            break
    if mod is None:
        fail(f"convert: torch {torch.__version__} keeps _add_onnxscript_fn "
             f"in none of {_ONNXSCRIPT_FN_MODULES}")
    kw = {"dynamo": False} if "dynamo" in inspect.signature(
        torch.onnx.export).parameters else {}
    orig = mod._add_onnxscript_fn
    mod._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        with torch.no_grad():
            torch.onnx.export(module, args, path, input_names=input_names,
                              output_names=output_names,
                              opset_version=P12_OPSET,
                              do_constant_folding=True, **kw)
    finally:
        mod._add_onnxscript_fn = orig
    return sorted({n.op_type for n in read_onnx(path).nodes})


def _tests_dir_on_path():
    """The FunASR module trees (tests/torch_funasr_export.py), the
    FunASR-layout state dicts (tests/funasr_numpy_ref.py) and the ONNX
    writer (tests/torch_onnx_fixtures.py): numpy and torch only."""
    path = os.path.join(REPO, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)


def funasr_yaml(cfg, timestamp: bool) -> str:
    """A FunASR config.yaml of `cfg`'s widths and depths."""
    import yaml

    return yaml.safe_dump({
        "frontend_conf": {"fs": FS, "n_mels": cfg.frontend.n_mels,
                          "lfr_m": cfg.frontend.lfr_m,
                          "lfr_n": cfg.frontend.lfr_n},
        "encoder_conf": {"output_size": cfg.encoder.output_size,
                         "num_blocks": cfg.encoder.num_blocks,
                         "attention_heads": cfg.encoder.attention_heads,
                         "linear_units": cfg.encoder.linear_units,
                         "kernel_size": cfg.encoder.kernel_size},
        "decoder_conf": {"num_blocks": cfg.decoder.num_blocks,
                         "attention_heads": cfg.decoder.attention_heads,
                         "linear_units": cfg.decoder.linear_units,
                         "kernel_size": cfg.decoder.kernel_size,
                         "sanm_shfit": 0},
        "predictor_conf": {"threshold": 1.0, "tail_threshold": 0.45,
                           "use_timestamp": timestamp},
        "vocab_size": cfg.vocab_size})


def _within(got, want, tol: float) -> tuple:
    """(max |got - want|, the limit tol of want's range)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    limit = tol * max(1.0, float(np.abs(want).max()) if want.size else 0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err, limit


def convert_timed(src: str, dst: str, kind: str, numbers: dict) -> dict:
    """read the source's model.pt, convert, write dst: each step's
    seconds into numbers. Returns the converted tree."""
    from asr2pass_tpu_torch.tools import convert_funasr as conv

    t1 = time.perf_counter()
    sd = conv.read_source(src)
    numbers["read_pt_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    params = conv.CONVERTERS[kind](sd)
    numbers["convert_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    conv.write_dir(src, dst, params)
    numbers["write_npz_s"] = time.perf_counter() - t1
    return params


def verify_with_control(label: str, src: str, params, kind: str,
                        corrupt, numbers: dict, after=None) -> float:
    """--verify on the card at the CLI's default tolerance, then
    `after()`, then the same with `corrupt(params)` applied, which must
    raise."""
    import copy

    from asr2pass_tpu_torch.tools import convert_funasr as conv

    t1 = time.perf_counter()
    diff = conv.verify_against_onnx(src, params, kind, device="cuda")
    numbers["verify_s"] = time.perf_counter() - t1
    numbers["verify_max_abs_diff"] = diff
    if after is not None:
        after()
    bad = copy.deepcopy(params)
    corrupt(bad)
    try:
        conv.verify_against_onnx(src, bad, kind, device="cuda")
    except AssertionError as e:
        numbers["control"] = str(e).splitlines()[0][:120]
    else:
        fail(f"convert: {label}'s wrong-weights control passed --verify")
    print(f"convert: {label} --verify on the card max|diff| {diff:.3e} "
          f"(limit 1e-3) in {numbers['verify_s']:.1f} s; wrong weights "
          f"raise: {numbers['control']}", flush=True)
    return diff


def convert_asr_phase(tmp: str, card: str):
    """12a. paraformer_large with the timestamp head in FunASR's layout,
    seeded with numpy, exported to a 4-output model.onnx at P12_T
    frames, converted and verified on the card. Returns (launches of the
    verify, numbers, the source dir)."""
    import numpy as np
    import torch

    from asr2pass_tpu_torch.config import paraformer_large
    from asr2pass_tpu_torch.frontend.audio import write_kaldi_cmvn
    from asr2pass_tpu_torch.models import sanm_decoder
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.runtime.offline_api import OfflineRecognizer
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.tools.onnx_reader import OnnxExecutor, read_onnx

    _tests_dir_on_path()
    from funasr_numpy_ref import make_state_dict
    from torch_funasr_export import TorchParaformer, load_numpy_state_dict

    cfg = paraformer_large(timestamp=True)
    e, dc = cfg.encoder, cfg.decoder
    numbers = {"card": card, "T": P12_T}
    src, dst = os.path.join(tmp, "funasr_asr"), os.path.join(tmp, "conv_asr")
    os.makedirs(src)
    with CLOCK.part("build"):
        t1 = time.perf_counter()
        sd = make_state_dict(np.random.default_rng(120),
                             d_in=e.input_size, d_model=e.output_size,
                             enc_blocks=e.num_blocks,
                             dec_blocks=dc.num_blocks,
                             ffn_dim=e.linear_units, vocab=cfg.vocab_size,
                             enc_kernel=e.kernel_size,
                             dec_kernel=dc.kernel_size, timestamp=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(src, "model.pt"))
        with open(os.path.join(src, "config.yaml"), "w") as f:
            f.write(funasr_yaml(cfg, timestamp=True))
        with open(os.path.join(src, "tokens.json"), "w",
                  encoding="utf-8") as f:
            json.dump(cjk_tokens(cfg.vocab_size), f, ensure_ascii=False)
        write_kaldi_cmvn(os.path.join(src, "am.mvn"),
                    np.full(e.input_size, -12.0, np.float32),
                    np.full(e.input_size, 0.25, np.float32))
        numbers["state_dict_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        module = load_numpy_state_dict(TorchParaformer(
            e.input_size, e.output_size, e.num_blocks, dc.num_blocks,
            e.attention_heads, e.linear_units, cfg.vocab_size,
            kernel=e.kernel_size, timestamp=True), sd).eval()
        ops = onnx_export(module, (torch.randn(1, P12_T, e.input_size),
                                   torch.tensor([P12_T])),
                          os.path.join(src, "model.onnx"),
                          ["speech", "speech_lengths"],
                          ["logits", "token_num", "us_alphas",
                           "us_cif_peak"])
        numbers["export_s"] = time.perf_counter() - t1
        del module, sd
        numbers["onnx_bytes"] = os.path.getsize(os.path.join(src,
                                                             "model.onnx"))
        t1 = time.perf_counter()
        g = read_onnx(os.path.join(src, "model.onnx"))
        numbers["read_onnx_s"] = time.perf_counter() - t1
        numbers["nodes"] = len(g.nodes)
        params = convert_timed(src, dst, "asr", numbers)
    print(f"convert: 12a paraformer_large(timestamp) FunASR dir: state "
          f"dict {numbers['state_dict_s']:.1f} s, ONNX export (opset "
          f"{P12_OPSET}) {numbers['export_s']:.1f} s, {numbers['onnx_bytes']}"
          f" bytes, {numbers['nodes']} nodes of {len(ops)} op types {ops}; "
          f"read_onnx {numbers['read_onnx_s']:.1f} s; model.pt read "
          f"{numbers['read_pt_s']:.1f} s, conversion "
          f"{numbers['convert_s']:.1f} s, weights.npz written "
          f"{numbers['write_npz_s']:.1f} s", flush=True)

    # --verify on the card and its forward's kernel launches; the control
    # scales one encoder block's first FFN weight
    tq, launches = [], {}

    def corrupt(p):
        w1 = p["encoder"]["rest"]["ffn"]["w1"]
        k = len(w1["w"]) // 2
        w1["w"][k] = w1["w"][k] * 1.1

    def decoder_tq(f):
        def call(params, ac, *a, **kw):
            tq.append(ac.shape[1])
            return f(params, ac, *a, **kw)
        return call

    torch.cuda.synchronize()
    att.reset_launch_counts()
    with wrapped(sanm_decoder, "apply", decoder_tq):
        verify_with_control(
            "12a", src, params, "asr", corrupt, numbers,
            after=lambda: launches.update(att.launch_counts_by_dtype()))
    want = e.num_blocks + (dc.num_blocks if tq[0] >= 256 else 0)
    got = launches["mh_flash_attention"]["float32"]
    others = sum(n for name, by in launches.items() for dt, n in by.items()
                 if (name, dt) != ("mh_flash_attention", "float32"))
    numbers["decoder_tq"] = tq
    print(f"convert: 12a the verify's forward launched {launches} (decoder "
          f"Tq {tq[0]}; expected mh_flash_attention fp32 {want}: 50 encoder "
          f"+ 16 cross where Tq >= 256)", flush=True)
    if got != want or others:
        fail(f"convert: 12a launched {launches}, expected "
             f"mh_flash_attention {want} times in float32")

    # the executor's link in the oracle chain: the card against the CPU
    feats = (np.random.default_rng(121).standard_normal(
        (1, P12_T, e.input_size)) * 0.5).astype(np.float32)
    lens = np.asarray([P12_T], np.int64)
    outs = {}
    for dev in ("cuda", "cpu"):
        with CLOCK.part(on_cpu(dev)):
            ex = OnnxExecutor(g, dev)
            ex(feats, lens)                     # warm
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = ex(feats, lens)
            outs[dev] = [o.cpu().numpy() for o in out]
            numbers[f"executor_ms_{dev}"] = (time.perf_counter() - t1) * 1e3
            del ex
    # token_num is the graph's float sum of the alphas (FunASR rounds it
    # to the decoder's length): held like the other floats, and the
    # token count, the logits' length, must be equal
    gate = {name: _within(outs["cuda"][k], outs["cpu"][k], P12_EXEC_TOL)
            for k, name in enumerate(("logits", "token_num", "us_alphas",
                                      "us_cif_peak"))}
    tokens = [outs[dev][0].shape[1] for dev in ("cuda", "cpu")]
    gate["token_count"] = (float(tokens[0] != tokens[1]), 0.0)
    numbers["executor_card_vs_cpu"] = gate
    print(f"convert: 12a executor on the card {numbers['executor_ms_cuda']:.1f}"
          f" ms, on the CPU {numbers['executor_ms_cpu']:.1f} ms ({card}); "
          f"card vs CPU (max |diff|, limit): {gate}; logits "
          f"{outs['cuda'][0].shape} / {outs['cpu'][0].shape}, token_num "
          f"{outs['cuda'][1].tolist()} / {outs['cpu'][1].tolist()}",
          flush=True)
    if not all(err <= limit for err, limit in gate.values()):
        fail("convert: 12a the executor on the card differs from the CPU")

    # a drop-in model dir: phase 3's weights.npz layout, and it serves
    def layout(path):
        with np.load(path) as z:
            return {k: (z[k].shape, str(z[k].dtype)) for k in z.files}

    got_l = layout(os.path.join(dst, "weights.npz"))
    want_l = layout(os.path.join(tmp, "model", "weights.npz"))
    same = got_l == want_l
    with CLOCK.part("build"):
        t1 = time.perf_counter()
        b = load_offline_bundle(dst)
        rec = OfflineRecognizer(ParaformerOffline(b.params, b.cfg, b.vocab,
                                                  cmvn=b.cmvn))
        numbers["load_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res = rec.transcribe(synth_audio(15.0, 122))
    numbers["transcribe_15s_s"] = time.perf_counter() - t1
    print(f"convert: 12a the converted dir has phase 3's weights.npz keys, "
          f"shapes and dtypes: {same} ({len(got_l)} arrays); loaded in "
          f"{numbers['load_s']:.1f} s; OfflineRecognizer.transcribe 15 s on "
          f"the card: {len(res.text)} chars, {len(res.timestamps)} stamps, "
          f"{numbers['transcribe_15s_s']:.2f} s", flush=True)
    if not same:
        diff = sorted(set(got_l.items()) ^ set(want_l.items()))[:6]
        fail(f"convert: 12a's weights.npz differs from phase 3's: {diff}")
    if not (res.text and res.timestamps and b.cfg.predictor.use_timestamp):
        fail("convert: 12a the converted dir gave no text or timestamps")
    return launches, numbers, src


def convert_kinds_phase(tmp: str, card: str):
    """12b. FSMN-VAD and the CT-Transformer (offline and VadRealtime) at
    full width, the streaming pair and SenseVoice at full width and
    reduced depth, each exported, converted and verified on the card,
    with a wrong-weights control each. Returns (numbers, the VAD's
    source and converted dirs)."""
    import dataclasses

    import numpy as np
    import torch

    from asr2pass_tpu_torch.config import (PuncConfig, VadConfig,
                                           paraformer_large_online,
                                           sensevoice_small)
    from asr2pass_tpu_torch.models.ct_transformer import vad_mask

    _tests_dir_on_path()
    from funasr_numpy_ref import (make_punc_state_dict, make_state_dict,
                                  make_vad_state_dict)
    from torch_funasr_export import (TorchCTTransformer,
                                     TorchCTTransformerVadRealtime,
                                     TorchFsmnVad, TorchOnlineDecoder,
                                     TorchOnlineEncoder, TorchSenseVoice,
                                     load_numpy_state_dict)

    out = {}

    def new_src(name, sd, yaml_text):
        src = os.path.join(tmp, f"funasr_{name}")
        os.makedirs(src)
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   os.path.join(src, "model.pt"))
        with open(os.path.join(src, "config.yaml"), "w") as f:
            f.write(yaml_text)
        return src

    def run(name, kind, src, corrupt, numbers):
        dst = os.path.join(tmp, f"conv_{name}")
        with CLOCK.part("build"):
            params = convert_timed(src, dst, kind, numbers)
        verify_with_control(f"12b {name}", src, params, kind, corrupt,
                            numbers)
        out[name] = numbers
        return dst

    # FSMN-VAD, VadConfig()'s widths and depth
    vc = VadConfig()
    vd = dict(input_dim=vc.input_dim, affine_dim=140,
              linear_dim=vc.hidden_dim, proj_dim=vc.proj_dim,
              layers=vc.fsmn_layers, lorder=vc.lorder,
              output_dim=vc.output_dim)
    nums = {}
    with CLOCK.part("build"):
        t1 = time.perf_counter()
        sd = make_vad_state_dict(np.random.default_rng(123), **vd)
        vad_src = new_src("vad", sd, "model_conf: {}\n")
        caches = [torch.zeros(1, vd["proj_dim"], vd["lorder"] - 1, 1)
                  for _ in range(vd["layers"])]
        nums["ops"] = onnx_export(
            load_numpy_state_dict(TorchFsmnVad(**vd), sd).eval(),
            (torch.randn(1, 25, vd["input_dim"]), *caches),
            os.path.join(vad_src, "model.onnx"),
            ["speech"] + [f"in_cache_{i}" for i in range(vd["layers"])],
            ["probs"] + [f"out_cache_{i}" for i in range(vd["layers"])])
        nums["export_s"] = time.perf_counter() - t1
    vad_dst = run("vad", "vad", vad_src,
                  lambda p: p["blocks"][0].__setitem__(
                      "taps", p["blocks"][0]["taps"] + 0.05), nums)

    # the CT-Transformer, PuncConfig()'s widths and depth: the offline
    # export and the VadRealtime one (auto-detected from its inputs)
    pc = PuncConfig()
    heads_yaml = (f"encoder_conf:\n  attention_heads: "
                  f"{pc.attention_heads}\n")
    pk = dict(vocab=pc.vocab_size, d_model=pc.att_dim, blocks=pc.num_blocks,
              heads=pc.attention_heads, ffn=pc.linear_units)
    with CLOCK.part("build"):
        sd = make_punc_state_dict(np.random.default_rng(124),
                                  vocab=pc.vocab_size, d_model=pc.att_dim,
                                  blocks=pc.num_blocks,
                                  ffn_dim=pc.linear_units,
                                  kernel=pc.kernel_size)
    t = 24
    for name, cls, args, names in (
            ("punc", TorchCTTransformer,
             (torch.randint(0, pc.vocab_size, (1, t)), torch.tensor([t])),
             ["input", "text_lengths"]),
            ("punc_online", TorchCTTransformerVadRealtime,
             (torch.randint(0, pc.vocab_size, (1, t), dtype=torch.int32),
              torch.tensor([t], dtype=torch.int32),
              torch.from_numpy(vad_mask(t, 9))[None, None],
              torch.from_numpy(vad_mask(t, 9))[None, None]),
             ["inputs", "text_lengths", "vad_mask", "sub_masks"])):
        nums = {}
        with CLOCK.part("build"):
            t1 = time.perf_counter()
            src = new_src(name, sd, heads_yaml)
            nums["ops"] = onnx_export(
                load_numpy_state_dict(cls(**pk), sd).eval(), args,
                os.path.join(src, "model.onnx"), names, ["logits"])
            nums["export_s"] = time.perf_counter() - t1

        def corrupt(p):
            qkv = p["encoder"]["first"]["att"]["qkv"]
            qkv["w"] = qkv["w"] + 0.03

        run(name, "punc", src, corrupt, nums)
    del sd

    # the streaming pair, paraformer_large_online's widths, reduced depth
    n_enc, n_dec = P12_ONLINE_BLOCKS
    oc = paraformer_large_online()
    oc = dataclasses.replace(
        oc, encoder=dataclasses.replace(oc.encoder, num_blocks=n_enc),
        decoder=dataclasses.replace(oc.decoder, num_blocks=n_dec))
    e = oc.encoder
    nums = {"blocks": [n_enc, n_dec]}
    with CLOCK.part("build"):
        t1 = time.perf_counter()
        sd = make_state_dict(np.random.default_rng(125), d_in=e.input_size,
                             d_model=e.output_size, enc_blocks=n_enc,
                             dec_blocks=n_dec, ffn_dim=e.linear_units,
                             vocab=oc.vocab_size)
        src = new_src("online", sd, funasr_yaml(oc, timestamp=False))
        w = sum(oc.chunk_size)              # the [cache | new] window
        nums["ops"] = onnx_export(
            load_numpy_state_dict(TorchOnlineEncoder(
                d_in=e.input_size, d_model=e.output_size, blocks=n_enc,
                heads=e.attention_heads, ffn=e.linear_units,
                kernel=e.kernel_size), sd).eval(),
            (torch.randn(1, w, e.input_size),
             torch.tensor([w], dtype=torch.int32)),
            os.path.join(src, "model.onnx"), ["speech", "speech_lengths"],
            ["enc", "enc_len", "alphas"])
        kern = oc.decoder.kernel_size
        caches = [torch.zeros(1, e.output_size, kern - 1)
                  for _ in range(n_dec)]
        nums["ops"] = sorted(set(nums["ops"]) | set(onnx_export(
            load_numpy_state_dict(TorchOnlineDecoder(
                d_model=e.output_size, blocks=n_dec,
                heads=oc.decoder.attention_heads,
                ffn=oc.decoder.linear_units, kernel=kern,
                vocab=oc.vocab_size), sd).eval(),
            (torch.randn(1, w, e.output_size),
             torch.tensor([w], dtype=torch.int32),
             torch.randn(1, 3, e.output_size),
             torch.tensor([3], dtype=torch.int32), *caches),
            os.path.join(src, "decoder.onnx"),
            ["enc", "enc_len", "acoustic_embeds", "acoustic_embeds_len"]
            + [f"in_cache_{i}" for i in range(n_dec)],
            ["logits", "sample_ids"]
            + [f"out_cache_{i}" for i in range(n_dec)])))
        nums["export_s"] = time.perf_counter() - t1
    run("online", "online", src,
        lambda p: p["encoder"]["after_norm"].__setitem__(
            "g", p["encoder"]["after_norm"]["g"] + 0.05), nums)
    del sd

    # SenseVoice, sensevoice_small()'s widths, reduced depth
    svc = sensevoice_small()
    n_blk, n_tp = P12_SVS_BLOCKS
    se = svc.encoder
    nums = {"blocks": [n_blk, n_tp]}
    with CLOCK.part("build"):
        t1 = time.perf_counter()
        torch.manual_seed(126)
        m = TorchSenseVoice(d_in=se.input_size, d_model=se.output_size,
                            blocks=n_blk, tp_blocks=n_tp,
                            heads=se.attention_heads, ffn=se.linear_units,
                            vocab=svc.vocab_size, n_embed=16,
                            kernel=se.kernel_size).eval()
        src = new_src("sensevoice",
                      {k: v.numpy() for k, v in m.state_dict().items()},
                      f"encoder_conf:\n  attention_heads: "
                      f"{se.attention_heads}\n")
        nums["ops"] = onnx_export(
            m, (torch.randn(1, 30, se.input_size),
                torch.tensor([30], dtype=torch.int32), torch.tensor([3]),
                torch.tensor([14])),
            os.path.join(src, "model.onnx"),
            ["speech", "speech_lengths", "language", "textnorm"],
            ["ctc_logits"])
        nums["export_s"] = time.perf_counter() - t1
        del m
    run("sensevoice", "sensevoice", src,
        lambda p: p["ctc"].__setitem__("w", p["ctc"]["w"] * 1.05), nums)
    return out, vad_src, vad_dst


def convert_tools_phase(tmp: str, vad_src: str, vad_dst: str, card: str):
    """12c. fetch_model --verify on 12b's FSMN-VAD source dir; DnsmosScorer
    on hand-encoded graphs with DNSMOS's contract, card against CPU;
    filter_segments over phase 5's recognizer with phase 7's VAD.
    Returns numbers."""
    from types import SimpleNamespace

    import numpy as np

    from asr2pass_tpu_torch.tools import fetch_model
    from asr2pass_tpu_torch.tools.quality import DnsmosScorer
    from asr2pass_tpu_torch.tools.segment_filter import filter_segments
    from asr2pass_tpu_torch.tools.transcribe import build_recognizer

    _tests_dir_on_path()
    from torch_onnx_fixtures import dnsmos_graphs

    numbers = {"card": card}
    prov = os.path.join(tmp, "prov_vad")
    t1 = time.perf_counter()
    rc = fetch_model.main([vad_src, "--out", prov, "--verify"])
    numbers["fetch_model_s"] = time.perf_counter() - t1

    def npz(path):
        with np.load(os.path.join(path, "weights.npz")) as z:
            return {k: z[k] for k in z.files}

    a, b = npz(prov), npz(vad_dst)
    equal = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    print(f"tools: 12c fetch_model --verify on the local FSMN-VAD dir: rc "
          f"{rc}, {numbers['fetch_model_s']:.1f} s, weights.npz bit-equal "
          f"to 12b's: {equal}", flush=True)
    if rc != 0 or not equal:
        fail("tools: 12c fetch_model on the local dir failed its gates")

    d = os.path.join(tmp, "dnsmos")
    os.makedirs(d)
    dnsmos_graphs(d, seed=127)
    audio = (np.random.default_rng(128).standard_normal(12 * FS) * 0.1
             ).astype(np.float32)
    scores = {}
    for dev in ("cuda", "cpu"):
        with CLOCK.part(on_cpu(dev)):
            sc = DnsmosScorer(d, device=dev)
            t1 = time.perf_counter()
            scores[dev] = sc.score(audio)
            numbers[f"dnsmos_12s_ms_{dev}"] = (time.perf_counter() - t1) * 1e3
    err = max(abs(scores["cuda"][k] - scores["cpu"][k])
              for k in scores["cpu"])
    numbers.update(dnsmos=scores, dnsmos_max_abs_err=err)
    print(f"tools: 12c DnsmosScorer on DNSMOS-contract graphs, 12 s: card "
          f"{scores['cuda']} ({numbers['dnsmos_12s_ms_cuda']:.1f} ms), CPU "
          f"max |diff| {err:.3e} (limit {P12_DNSMOS_TOL})", flush=True)
    if not err <= P12_DNSMOS_TOL or len(scores["cuda"]) != 4:
        fail("tools: 12c DNSMOS scores differ between card and CPU")

    # filter_segments over phase 5's recognizer with phase 7's VAD: the
    # recognizer's own texts as references keep every segment; a
    # reference with every token changed drops its segment
    rec = build_recognizer(SimpleNamespace(
        model_dir=os.path.join(tmp, "model"),
        vad_dir=os.path.join(tmp, "vad"), punc_dir="", itn=False,
        device="cuda"))
    wave, spans = two_pass_audio()
    segs = rec.transcribe(wave).segments
    own = [t for t, _ in rec.asr.recognize_batch(
        [wave[s * FS // 1000: e * FS // 1000] for s, e in segs])]
    kept = filter_segments(rec, wave, FS, ref_texts=own)
    changed = list(own)
    changed[1] = "".join("X" for _ in changed[1])
    kept_c = filter_segments(rec, wave, FS, ref_texts=changed)
    ok = (len(segs) == len(spans) and all(own)
          and [k[2] for k in kept] == own
          and all(k[3] == 0.0 for k in kept)
          and [k[2] for k in kept_c] == [t for i, t in enumerate(own)
                                         if i != 1])
    numbers["filter"] = {"segments": len(segs), "kept_own": len(kept),
                         "kept_changed": len(kept_c)}
    print(f"tools: 12c filter_segments: {len(segs)} VAD segments, the "
          f"recognizer's own texts keep {len(kept)}, with segment 1's "
          f"reference changed {len(kept_c)}: {ok}", flush=True)
    if not ok:
        fail(f"tools: 12c filter_segments kept {kept} / {kept_c}")
    return numbers


def phase12(tmp: str, card: str):
    """Phase 12. Returns ({path: launches}, {sub-phase: numbers})."""
    import torch

    print(f"convert: torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    with CLOCK.phase("12a"):
        launches, n_asr, _ = convert_asr_phase(tmp, card)
    with CLOCK.phase("12b"):
        n_kinds, vad_src, vad_dst = convert_kinds_phase(tmp, card)
    with CLOCK.phase("12c"):
        n_tools = convert_tools_phase(tmp, vad_src, vad_dst, card)
    return {"convert": launches}, {"12a": n_asr, "12b": n_kinds,
                                   "12c": n_tools}


# ---------------------------------------------------------------------------
# phase 13: tensor and sequence parallelism on torch.distributed
# ---------------------------------------------------------------------------

P13_SEGMENTS = 16            # 13a: 16 x 60 s, then one 150 s and one 270 s
P13_LONG = (150.0, 270.0)
P13_SP_SECONDS = 300.0       # 13b: T ~ 5000 LFR frames, past sp_threshold
P13_SP_THRESHOLD = 4096      # ParaformerOffline's default, in LFR frames
P13_TRAIN_STEPS = 2          # 13c: P11_TRAIN_B x P11_TRAIN_T frames
# target lengths of 13c's 8 rows: the dp halves carry unequal token counts
P13_TRAIN_TARGETS = (60, 55, 48, 60, 40, 52, 60, 45)
P13_PRUNE_SHAPE = (16, 1028, 25055)   # 13d: SenseVoice's 16 x 60 s logits
P13_PRUNE_K = 64
P13_LOGP_TOL = 1e-5
# the multi-card SenseVoice: sensevoice_small's widths, its vocab one
# larger (25055 splits over no tp > 1, in either package), reduced depth
P13_SVS_VOCAB = 25056
P13_SVS_BLOCKS = (6, 2)
P13_SVS_SEGMENTS = 4         # x 60 s
P13_TIMEOUT_S = 120          # a collective that does not complete raises
# 13g: the whole-heads model, paraformer_large but 3 heads of 128 (d 384:
# 3 splits over neither 2 nor 4 ranks) at reduced depth, its FFN and
# vocab widths unchanged; B x 60 s of random features
P13G_HEADS = 3
P13G_BLOCKS = (12, 4)
P13G_BATCH = 4
P13G_RANKS = 2               # gloo ranks sharing the one card
P13G_GATHER_RUNS = 3


def p13_device():
    """This process's card."""
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def p13_record(start: int, lengths, out) -> tuple:
    """One forward on the host: (its first row in the chunk, the rows'
    lengths, token_num, logits, encodings, alphas)."""
    return (start, list(lengths), out.token_num.cpu(),
            out.logits.float().cpu(), out.enc.float().cpu(),
            out.alphas.float().cpu())


def p13_capture(rec) -> list:
    """Record each forward of a ParaformerOffline (p13_record)."""
    fwds = []
    orig = rec._forward

    def forward(feats, lengths, *a, **kw):
        out = orig(feats, lengths, *a, **kw)
        fwds.append(p13_record(rec.dp_rank * feats.shape[0], lengths, out))
        return out

    rec._forward = forward
    return fwds


def p13_forward_gate(label: str, ref: list, got: list,
                     exact: bool) -> dict:
    """Forwards `got` against `ref` (the same chunks in the same order),
    row by row on the valid frames: encodings within CPU_TOL of their
    range (at least 1), alphas within CPU_TOL, token_num equal up to the
    smaller of the two token buffers (the forwards' max_tokens, T//2 + 8
    of each one's padded T, as in the JAX package: the sequence-parallel
    forward pads 5000 frames to 5056 where the bucketed one pads to 5120,
    and a model that fires on more than half the frames fills both;
    such rows are counted in `token_num_capped`); where
    `exact`, also the logits within CPU_TOL of their range and the greedy
    ids equal. Otherwise the logits are measured, not gated: CIF carries
    each frame's remainder into the next token, so the alphas' rounding
    differences add up along the segment and move where frames split
    between tokens (the encodings, which hold the sharded work, are
    gated; the decoder is gated on equal inputs by p13_decoder_gate).
    Returns the worst ratios, the tokens whose logits pass the limit and
    the first token of each row that does not, and the ids that
    differ."""
    if len(ref) != len(got):
        fail(f"{label}: {len(got)} forwards against {len(ref)}")
    n_out = {"rows": 0, "tokens": 0, "tol_ratio": 0.0, "enc_tol_ratio": 0.0,
             "alphas_max_abs_err": 0.0, "tokens_within_limit": 0,
             "first_token_past_limit": [], "ids_differing": 0,
             "token_num_capped": 0}
    for r_fwd, g_fwd in zip(ref, got):
        _, r_lens, r_n, r_lg, r_enc, r_al = r_fwd
        start, g_lens, g_n, g_lg, g_enc, g_al = g_fwd
        for j, length in enumerate(g_lens):
            row = start + j
            if length == 0:
                continue
            if row >= len(r_lens) or r_lens[row] != length:
                fail(f"{label}: row {row} of length {length} is not the "
                     "reference's")
            e_ref = r_enc[row, :length]
            e_lim = CPU_TOL * max(1.0, e_ref.abs().max().item())
            e_err = (g_enc[j, :length] - e_ref).abs().max().item()
            a_err = (g_al[j, :length] - r_al[row, :length]).abs().max().item()
            n_out["enc_tol_ratio"] = max(n_out["enc_tol_ratio"],
                                         e_err / e_lim)
            n_out["alphas_max_abs_err"] = max(n_out["alphas_max_abs_err"],
                                              a_err)
            if e_err > e_lim or a_err > CPU_TOL:
                fail(f"{label}: row {row} encodings differ by {e_err:.3e} "
                     f"(limit {e_lim:.3e}), alphas by {a_err:.3e}")
            cap = min(r_lg.shape[1], g_lg.shape[1])
            n = min(int(r_n[row]), cap)
            if min(int(g_n[j]), cap) != n:
                fail(f"{label}: row {row} token_num {int(g_n[j])}, "
                     f"reference {int(r_n[row])} (token buffers "
                     f"{g_lg.shape[1]}, {r_lg.shape[1]})")
            n_out["token_num_capped"] += int(max(int(r_n[row]),
                                                 int(g_n[j])) >= cap)
            if n == 0:
                continue
            n_out["rows"] += 1
            n_out["tokens"] += n
            a, b = g_lg[j, :n], r_lg[row, :n]
            limit = CPU_TOL * max(1.0, b.abs().max().item())
            err = (a - b).abs().amax(dim=-1)
            n_out["tol_ratio"] = max(n_out["tol_ratio"],
                                     err.max().item() / limit)
            past = (err > limit).nonzero().flatten()
            n_out["tokens_within_limit"] += n - len(past)
            if len(past):
                n_out["first_token_past_limit"].append(int(past[0]))
            differ = int((a.argmax(-1) != b.argmax(-1)).sum())
            n_out["ids_differing"] += differ
            if exact and (len(past) or differ):
                fail(f"{label}: row {row} logits differ by "
                     f"{err.max().item():.3e} (limit {limit:.3e}), {differ} "
                     "ids differ")
    return n_out


def p13_decoder_gate(label: str, whole, local, cfg, feats, lengths) -> dict:
    """The tensor-parallel decoder against the unsharded one on the same
    inputs (the unsharded model's encodings and CIF embeddings of one
    batch): logits within CPU_TOL of their range on each row's tokens,
    ids equal but at a near-tie (p13_ctc_gate's rule)."""
    import torch

    from asr2pass_tpu_torch.models import cif, paraformer, sanm_decoder
    from asr2pass_tpu_torch.models.layers import length_mask

    max_tokens = feats.shape[1] // 2 + 8
    with torch.inference_mode():
        mask = length_mask(lengths, feats.shape[1])
        out = paraformer.apply(whole, cfg, feats, lengths,
                               max_tokens=max_tokens)
        ac, n, _ = cif.fire_offline(
            out.enc, out.alphas, cfg.predictor.threshold,
            cfg.predictor.tail_threshold, max_tokens=max_tokens,
            lengths=lengths)
        tok_mask = length_mask(n, ac.shape[1])
        res = [sanm_decoder.apply(m.decoder, ac, out.enc, enc_mask=mask,
                                  mask=tok_mask, cfg=cfg.decoder)
               for m in (whole, local)]
    return p13_ctc_gate(label, res[0].float().cpu(), res[1].float().cpu(),
                        n.tolist())


def p13_ctc_gate(label: str, ref, got, lengths) -> dict:
    """CTC logits [B, T, V] on each row's valid frames: within CPU_TOL of
    the reference's range (at least 1); a frame's argmax may differ at a
    near-tie only (reference top-two margin at most twice the frame's
    largest logit difference)."""
    worst, ties, flips = 0.0, 0, 0
    for row, length in enumerate(lengths):
        a, b = got[row, :length], ref[row, :length]
        limit = CPU_TOL * max(1.0, b.abs().max().item())
        err = (a - b).abs().amax(dim=-1)
        worst = max(worst, err.max().item() / limit)
        if err.max().item() > limit:
            fail(f"{label}: row {row} logits differ by "
                 f"{err.max().item():.3e} (limit {limit:.3e})")
        top2 = b.topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) <= 2 * err
        ties += int(tie.sum())
        for pos in (a.argmax(-1) != b.argmax(-1)).nonzero().flatten():
            if not tie[pos]:
                fail(f"{label}: row {row} frame {int(pos)}: the id differs")
            flips += 1
    return {"rows": len(lengths), "tol_ratio": worst, "near_ties": ties,
            "id_flips_at_near_ties": flips}


def p13_texts_gate(label: str, ref: list, got: list, exact: bool) -> dict:
    """The results (texts and timestamps) equal where `exact`; else how
    many texts and how many results differ (the timestamps come from the
    upsampled alphas' peaks, which a rounding can move by a frame)."""
    if len(ref) != len(got):
        fail(f"{label}: {len(got)} results against {len(ref)}")
    texts = sum(a[0] != b[0] for a, b in zip(ref, got))
    results = sum(a != b for a, b in zip(ref, got))
    if exact and results:
        fail(f"{label}: {results} results differ from the unsharded "
             "recognizer's")
    return {"texts_differ": texts, "results_differ": results}


def p13_audio():
    """13a's 16 x 60 s + 150 s + 270 s and 13b's 300 s, seeded."""
    segs = [synth_audio(60.0, 300 + i) for i in range(P13_SEGMENTS)]
    segs += [synth_audio(s, 320 + i) for i, s in enumerate(P13_LONG)]
    return segs, synth_audio(P13_SP_SECONDS, 330)


def p13_run(rec, segs) -> dict:
    """One recognize_batch of the segments, warmed on the first: each
    forward recorded (p13_capture), the results, the kernel launches and
    collectives (counted from 0 just before), audio-s/s."""
    import torch

    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel import comm

    rec.recognize_batch(segs[:1])
    fwds = p13_capture(rec)
    torch.cuda.synchronize()
    att.reset_launch_counts()
    comm.reset_collective_counts()
    t0 = time.perf_counter()
    res = rec.recognize_batch(segs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del rec._forward
    return {"fwds": fwds, "res": res,
            "launches": att.launch_counts_by_dtype(),
            "collectives": comm.collective_counts(),
            "audio_s_per_s": sum(len(x) for x in segs) / FS / secs}


def p13_recognizers(bundle, whole, ref: dict, tp_mesh, segs,
                    label: str) -> dict:
    """13a: the tensor-parallel recognizer against the unsharded one
    (`whole`, whose p13_run of the same segments is `ref`): encodings,
    alphas, token_num, logits within CPU_TOL of their range and greedy
    ids equal (p13_forward_gate); the results equal at tp 1, and counted
    past it (a rounding there can move a timestamp by a frame with the
    ids equal); kernel launches equal (each rank counts its own);
    audio-s/s of each gated run. Past tp 1 also the decoder on equal
    inputs and a device profile of one run."""
    import torch

    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.frontend.lfr import lfr_len
    from asr2pass_tpu_torch.parallel.sharding import axis_size
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)

    n_tp = axis_size(tp_mesh, "tp")
    with CLOCK.part("build"):
        tp = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                               cmvn=bundle.cmvn, tp_mesh=tp_mesh)
    torch.cuda.reset_peak_memory_stats()
    got = p13_run(tp, segs)
    out = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "collectives_tp": got["collectives"],
           "audio_s_per_s_whole": ref["audio_s_per_s"],
           "audio_s_per_s_tp": got["audio_s_per_s"]}
    gate = p13_forward_gate(label, ref["fwds"], got["fwds"], exact=True)
    differ = p13_texts_gate(label, ref["res"], got["res"],
                            exact=n_tp == 1)
    if got["launches"] != ref["launches"]:
        fail(f"{label}: kernel launches {got['launches']}, unsharded "
             f"{ref['launches']}")
    if n_tp > 1:
        # the sharded decoder on the unsharded model's 16 x 60 s inputs
        fcfg = bundle.cfg.frontend
        first = segs[:P13_SEGMENTS]
        ns = [num_frames(len(x), fcfg) for x in first]
        feats = offline_frontend_device(first, ns, 1024, fcfg, *bundle.cmvn,
                                        device=whole.device)
        lengths = torch.tensor([lfr_len(n, fcfg.lfr_m, fcfg.lfr_n)
                                for n in ns], device=whole.device)
        out["decoder"] = p13_decoder_gate(f"{label} decoder", whole.model,
                                          tp.model, bundle.cfg, feats,
                                          lengths)
    heads = tp.model.encoder.first.att.qkv.w.shape[1] // 3 // (
        bundle.cfg.encoder.output_size // bundle.cfg.encoder.attention_heads)
    out.update(gate, **differ, heads_per_rank=heads,
               launches={k: {d: n for d, n in v.items() if n}
                         for k, v in got["launches"].items()},
               launches_by_dtype=got["launches"])
    print(f"{label}: {heads} heads a rank; forwards {gate}; decoder on "
          f"equal inputs {out.get('decoder', 'not run (tp 1)')}; "
          f"{differ}; launches {out['launches']} (= unsharded); "
          f"collectives of the run {out['collectives_tp']}; audio-s/s "
          f"tp {out['audio_s_per_s_tp']:.1f}, unsharded "
          f"{out['audio_s_per_s_whole']:.1f}", flush=True)
    if n_tp > 1:
        # the collectives' device time a rank (a world-size-1 group
        # launches no NCCL kernel, so the one-card run skips the trace)
        out["profile"] = device_profile(lambda: tp.recognize_batch(
            segs[:P13_SEGMENTS]), f"{label} 16 x 60 s", host_ops=False)
    return out


def p13_sp(bundle, whole, sp_mesh, seg, label: str) -> dict:
    """13b: one long segment through the sequence-parallel recognizer
    (apply_sp, plain attention) and the unsharded one (`whole`, kernel
    #3)."""
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    with CLOCK.part("build"):
        sp = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                               cmvn=bundle.cmvn, sp_mesh=sp_mesh,
                               sp_threshold=P13_SP_THRESHOLD)
    ref = p13_capture(whole)
    t0 = time.perf_counter()
    want = whole.recognize_batch([seg])
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    del whole._forward
    got = []

    def keep(out):
        got.append(p13_record(0, got_len, out))

    got_len = [ref[0][1][0]]
    att.reset_launch_counts()
    comm.reset_collective_counts()
    with wrapped(paraformer, "apply_sp", after(keep)):
        t0 = time.perf_counter()
        res = sp.recognize_batch([seg])
        torch.cuda.synchronize()
        sp_s = time.perf_counter() - t0
    collectives = comm.collective_counts()
    launches = att.launch_counts()
    if len(got) != 1:
        fail(f"{label}: {len(got)} sequence-parallel forwards, expected 1")
    gate = p13_forward_gate(label, ref, got, exact=False)
    differ = p13_texts_gate(label, want, res, exact=False)
    audio_s = len(seg) / FS
    out = dict(gate, **differ, launches=launches,
               collectives=collectives, t_lfr=got_len[0],
               audio_s_per_s_sp=audio_s / sp_s,
               audio_s_per_s_whole=audio_s / whole_s, results=res)
    print(f"{label}: T={got_len[0]}: forwards {gate}; {differ}; "
          f"launches {launches} (the encoder's attention is "
          f"plain); collectives {collectives}; audio-s/s sp "
          f"{out['audio_s_per_s_sp']:.1f}, unsharded "
          f"{out['audio_s_per_s_whole']:.1f}", flush=True)
    return out


def p13_tpsp(bundle, ref_res: list, sp_res: list, tp_mesh, sp_mesh, segs,
             label: str) -> dict:
    """13g: the recognizer given both meshes on `segs` (all but the last
    through TP, the last past P13_SP_THRESHOLD through SP): their results
    against the unsharded recognizer's (`ref_res`) and the last against
    the sequence-parallel recognizer's (`sp_res`), equal at tp 1 and
    counted past it; kernel launches by route (counted from 0 around the
    call: #1 and #2 must launch); the encoder gather's ms and the memory
    it adds; audio-s/s."""
    import torch

    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.parallel.sharding import axis_size, gather_whole
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    n_tp = axis_size(tp_mesh, "tp")
    with CLOCK.part("build"):
        rec = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                                cmvn=bundle.cmvn, tp_mesh=tp_mesh,
                                sp_mesh=sp_mesh,
                                sp_threshold=P13_SP_THRESHOLD)
    rec.recognize_batch(segs[:1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launch_counts()
    comm.reset_collective_counts()
    t0 = time.perf_counter()
    res = rec.recognize_batch(segs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_dtype = att.launch_counts_by_dtype()
    launches = {k: {d: n for d, n in v.items() if n}
                for k, v in by_dtype.items()}
    out = {"collectives": comm.collective_counts(),
           "launches_by_dtype": by_dtype,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "audio_s_per_s": sum(len(x) for x in segs) / FS / secs,
           "launches": launches}
    if not launches.get("mh_flash_attention") or \
            not launches.get("_attention_ss"):
        fail(f"{label}: the TP segments launched {launches}: #1 and #2 "
             "expected")
    with torch.inference_mode():
        base = torch.cuda.memory_allocated()
        gather_ms, added = [], 0
        for _ in range(P13G_GATHER_RUNS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            whole_enc = gather_whole(rec.model.encoder)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t0) * 1e3)
            added = torch.cuda.max_memory_allocated() - base
            del whole_enc
    out.update(gather_ms=gather_ms, gather_added_gib=added / 2**30,
               encoder_params=sum(p.numel() for p in
                                  rec.model.encoder.parameters()))
    exact = n_tp == 1
    out["tp"] = p13_texts_gate(f"{label} TP segments", ref_res, res[:-1],
                               exact)
    out["sp"] = p13_texts_gate(f"{label} SP segment", sp_res, res[-1:],
                               exact)
    if not exact and [len(t) for t, _ in res[-1:]] != \
            [len(t) for t, _ in sp_res]:
        fail(f"{label}: the SP segment has {len(res[-1][0])} characters, "
             f"the sequence-parallel recognizer's {len(sp_res[0][0])}")
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


def p13_int8_whole(bundle, mesh, gen, label: str) -> dict:
    """13g: phase 11a's w8a16 and w8a8 trees (the bf16 cast, quantized)
    sharded over `mesh`: no key sliced, and the shard's ids and logits
    on bf16 features equal to the unsharded int8 forward's; the shard's
    kernel launches."""
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel.sharding import (shard_params,
                                                      sliced_params)
    from asr2pass_tpu_torch.utils import cast_floats, quantize_params

    fcfg = bundle.cfg.frontend
    t_b = int(60.0 * 1000 / (fcfg.frame_shift_ms * fcfg.lfr_n))
    feats = torch.randn(P13G_BATCH, t_b, fcfg.lfr_dim, generator=gen,
                        device="cuda").to(torch.bfloat16)
    lens = torch.full((P13G_BATCH,), t_b, dtype=torch.long, device="cuda")
    sd16 = cast_floats(bundle.params, torch.bfloat16)
    out = {"launches_by_dtype": {k: dict.fromkeys(v, 0) for k, v in
                                 att.launch_counts_by_dtype().items()}}
    for form, weight_only in (("w8a16", True), ("w8a8", False)):
        whole = paraformer.from_state_dict(
            quantize_params(sd16, weight_only=weight_only), bundle.cfg,
            "cuda")
        local = shard_params(whole, mesh)
        with torch.inference_mode():
            torch.cuda.synchronize()
            att.reset_launch_counts()
            got = paraformer.apply(local, bundle.cfg, feats, lens,
                                   max_tokens=t_b // 2 + 8)
            torch.cuda.synchronize()
            by_dtype = att.launch_counts_by_dtype()
            for k, v in by_dtype.items():
                for d, n in v.items():
                    out["launches_by_dtype"][k][d] += n
            launches = {k: {d: n for d, n in v.items() if n}
                        for k, v in by_dtype.items()}
            ref = paraformer.apply(whole, bundle.cfg, feats, lens,
                                   max_tokens=t_b // 2 + 8)
        same = (torch.equal(got.logits, ref.logits)
                and torch.equal(got.token_num, ref.token_num)
                and torch.equal(got.logits.argmax(-1),
                                ref.logits.argmax(-1)))
        out[form] = {"sliced": len(sliced_params(local)), "equal": same,
                     "tokens": int(ref.token_num.sum()),
                     "launches": launches}
        if out[form]["sliced"] or not same:
            fail(f"{label} {form}: {out[form]['sliced']} keys sliced; ids "
                 f"and logits equal to the unsharded int8 forward: {same}")
        del whole, local, got, ref
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


def p13g_heads_cfg():
    """paraformer_large with P13G_HEADS heads of 128 and P13G_BLOCKS of
    depth (the FFN and vocab widths unchanged)."""
    import dataclasses

    from asr2pass_tpu_torch.config import paraformer_large

    cfg = paraformer_large()
    d = 128 * P13G_HEADS
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, output_size=d,
                                    attention_heads=P13G_HEADS,
                                    num_blocks=P13G_BLOCKS[0]),
        decoder=dataclasses.replace(cfg.decoder, attention_heads=P13G_HEADS,
                                    num_blocks=P13G_BLOCKS[1]),
        predictor=dataclasses.replace(cfg.predictor, idim=d))


def p13g_heads_forward(mesh, label: str) -> dict:
    """The whole-heads model (p13g_heads_cfg) sharded over the mesh's tp,
    which its heads do not split over: every attention module whole on
    each rank, the FFNs and the vocab head sliced; its forward on
    P13G_BATCH x 60 s of random features against the unsharded forward
    on the same card (p13_forward_gate, exact: logits within CPU_TOL of
    their range, token_num and ids equal); the kernels' launches."""
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel.sharding import (axis_size,
                                                      shard_params,
                                                      sliced_params,
                                                      whole_units)

    cfg = p13g_heads_cfg()
    n_tp = axis_size(mesh, "tp")
    dev = p13_device()
    with torch.no_grad():
        whole = paraformer.init(cfg, torch.Generator().manual_seed(13),
                                "cpu").to(dev)
    local = shard_params(whole, mesh)
    units = whole_units(whole, n_tp)
    attention = [n for n, m in whole.named_modules()
                 if type(m).__name__ in ("SanmAttention", "CrossAttention")]
    if sorted(units) != sorted(attention):
        fail(f"{label}: whole units {sorted(units)}, attention modules "
             f"{sorted(attention)}")
    t_b = int(60.0 * 1000 / (cfg.frontend.frame_shift_ms
                             * cfg.frontend.lfr_n))
    g = torch.Generator(device=dev).manual_seed(14)
    feats = torch.randn(P13G_BATCH, t_b, cfg.frontend.lfr_dim, generator=g,
                        device=dev)
    lens = torch.tensor([t_b - 37 * k for k in range(P13G_BATCH)],
                        device=dev)
    recs = {}
    with torch.inference_mode():
        for name, model in (("whole", whole), ("tp", local)):
            torch.cuda.synchronize()
            att.reset_launch_counts()
            out = paraformer.apply(model, cfg, feats, lens,
                                   max_tokens=t_b // 2 + 8)
            torch.cuda.synchronize()
            recs[name] = ([p13_record(0, lens.tolist(), out)],
                          {k: {d: n for d, n in v.items() if n} for k, v in
                           att.launch_counts_by_dtype().items()})
    gate = p13_forward_gate(label, recs["whole"][0], recs["tp"][0],
                            exact=True)
    res = dict(gate, tp=n_tp, whole_units=len(units),
               sliced=len(sliced_params(local)),
               qkv=list(local.encoder.first.att.qkv.w.shape),
               w1=list(local.encoder.first.ffn.w1.w.shape),
               launches_tp=recs["tp"][1], launches_whole=recs["whole"][1])
    if res["launches_tp"] != res["launches_whole"] or \
            not res["launches_tp"].get("mh_flash_attention"):
        fail(f"{label}: launches {res['launches_tp']}, unsharded "
             f"{res['launches_whole']}")
    print(f"{label}: {json.dumps(res)}", flush=True)
    return res


def p13_heads_recognizer(world: int, segs, label: str) -> dict:
    """13f: the whole-heads model (p13g_heads_cfg, seeded alike on every
    rank) through the recognizer at tp = world against the unsharded one
    (p13_recognizers: forwards gated, results counted)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.parallel.sharding import make_mesh
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline
    from asr2pass_tpu_torch.text.vocab import Vocab

    cfg = p13g_heads_cfg()
    d = cfg.frontend.lfr_dim
    with CLOCK.part("build"), torch.no_grad():
        model = paraformer.init(cfg, torch.Generator().manual_seed(13),
                                "cpu").to(p13_device())
    bundle = SimpleNamespace(
        params=model, cfg=cfg, vocab=Vocab(cjk_tokens(cfg.vocab_size)),
        cmvn=(np.full(d, -12.0, np.float32), np.full(d, 0.25, np.float32)))
    whole = ParaformerOffline(model, cfg, bundle.vocab, cmvn=bundle.cmvn)
    whole.recognize_batch(segs)
    return p13_recognizers(bundle, whole, p13_run(whole, segs),
                           make_mesh(world, tp=world), segs, label)


def p13g_heads_rank(rank: int, world: int, tmp: str) -> None:
    """One of P13G_RANKS gloo ranks on the one card (gloo carries the
    collectives of CUDA tensors through the host): p13g_heads_forward at
    tp = world; numbers to <tmp>/p13g_rank<rank>.json."""
    sys.path.insert(0, REPO)
    import datetime

    import torch
    import torch.distributed as dist

    from asr2pass_tpu_torch.parallel.sharding import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/p13g_rdv", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=P13_TIMEOUT_S))
    try:
        out = p13g_heads_forward(make_mesh(world, tp=world),
                                 f"13g rank {rank} heads whole at tp "
                                 f"{world} (gloo, one card)")
        with open(os.path.join(tmp, f"p13g_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def p13g_heads_start(tmp: str):
    """13g's whole heads on one card: P13G_RANKS gloo ranks there, started
    (they gate correctness only, so they run beside 13a-13e, as phase
    14's servers start beside phase 13); p13g_heads_join waits."""
    import torch.multiprocessing as mp

    return mp.spawn(p13g_heads_rank, args=(P13G_RANKS, tmp),
                    nprocs=P13G_RANKS, join=False)


def p13g_heads_join(ctx, tmp: str) -> list:
    """The ranks' numbers; raises if a rank failed."""
    while not ctx.join():
        pass
    out = []
    for r in range(P13G_RANKS):
        with open(os.path.join(tmp, f"p13g_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def p13_train(bundle, mesh, label: str) -> dict:
    """13c: make_sharded_train_step against train_step on the whole batch
    (threshold P11_CPU_THRESHOLD_SHIFT lower, as in 11b: the last CIF
    fire sits on the threshold): the losses, steps/s, peak memory."""
    import dataclasses

    import numpy as np
    import torch

    from asr2pass_tpu_torch.models import paraformer
    from asr2pass_tpu_torch.parallel.sharding import shard_params
    from asr2pass_tpu_torch.train import train

    cfg = dataclasses.replace(bundle.cfg, predictor=dataclasses.replace(
        bundle.cfg.predictor,
        threshold=bundle.cfg.predictor.threshold - P11_CPU_THRESHOLD_SHIFT))
    rng = np.random.default_rng(13)
    dev = p13_device()
    b = len(P13_TRAIN_TARGETS)
    batch = train.TrainBatch(
        feats=torch.from_numpy(rng.standard_normal(
            (b, P11_TRAIN_T, cfg.frontend.lfr_dim)).astype(np.float32)
        ).to(dev),
        feat_lens=torch.full((b,), P11_TRAIN_T, device=dev),
        targets=torch.from_numpy(rng.integers(
            4, cfg.vocab_size, (b, P11_TRAIN_U))).to(dev),
        target_lens=torch.tensor(P13_TRAIN_TARGETS, device=dev))
    losses = {}
    torch.cuda.reset_peak_memory_stats()
    for name in ("sharded", "whole"):
        model = paraformer.from_state_dict(bundle.params, cfg, dev)
        if name == "sharded":
            model = shard_params(model, mesh)
            run = train.make_sharded_train_step(cfg, mesh)
        else:
            run = lambda m, o, bt: train.train_step(m, o, bt, cfg)
        opt = train.make_optimizer(model)
        losses[name], secs = [], []
        for _ in range(P13_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[name].append(float(run(model, opt, batch)["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        # the first step sets up the communicators and the allocator
        losses[f"{name}_step_s"] = secs
        losses[f"{name}_steps_s"] = 1.0 / secs[-1]
        if name == "sharded":
            losses["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del model, opt
    for a, c in zip(losses["sharded"], losses["whole"]):
        if not abs(a - c) <= TRAIN_LOSS_RTOL * abs(c):
            fail(f"{label}: sharded loss {a} against {c} unsharded")
    print(f"{label}: losses sharded {losses['sharded']}, unsharded "
          f"{losses['whole']}; s a step sharded {losses['sharded_step_s']}, "
          f"unsharded {losses['whole_step_s']}; steps/s (the last step) "
          f"sharded {losses['sharded_steps_s']:.2f}, unsharded "
          f"{losses['whole_steps_s']:.2f}; peak "
          f"{losses['peak_gib']:.2f} GiB", flush=True)
    return losses


def p13_prune_gate(label: str, ids, logp, ref_ids, ref_logp,
                   ref_full) -> dict:
    """Each frame's candidate set equals the reference's, log-probs per
    id within P13_LOGP_TOL, except frames whose k-th and (k+1)-th
    log-probs are within that tolerance (the boundary a top-k may cut
    either way)."""
    import torch

    k = ids.shape[-1]
    if k < ref_full.shape[-1]:
        top = ref_full.topk(k + 1, dim=-1).values
        edge = (top[..., k - 1] - top[..., k]) <= P13_LOGP_TOL
    else:
        edge = torch.zeros(ids.shape[:-1], dtype=torch.bool,
                           device=ids.device)
    a, oa = ids.sort(dim=-1)
    b, ob = ref_ids.sort(dim=-1)
    same = (a == b).all(dim=-1)
    bad = ~same & ~edge
    if bad.any():
        fail(f"{label}: {int(bad.sum())} frames' candidate sets differ "
             "away from a top-k boundary tie")
    lp_err = (logp.gather(-1, oa) - ref_logp.gather(-1, ob)).abs()
    lp_err = torch.where(same[..., None], lp_err, 0).max().item()
    if lp_err > P13_LOGP_TOL:
        fail(f"{label}: candidate log-probs differ by {lp_err:.3e}")
    return {"frames": int(same.numel()), "boundary_ties": int(edge.sum()),
            "sets_differ_at_ties": int((~same).sum()),
            "logp_max_abs_err": lp_err}


def p13_prune(mesh, gen, label: str) -> dict:
    """13d: the sharded prune on SenseVoice-shaped logits against the
    whole prune."""
    import torch

    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.parallel.ctc_shard import (
        ctc_first_prune, ctc_first_prune_sharded)

    logits = torch.randn(*P13_PRUNE_SHAPE, generator=gen,
                         device="cuda") * 2.0
    comm.reset_collective_counts()
    ids, logp = ctc_first_prune_sharded(logits, mesh, "tp", k=P13_PRUNE_K)
    collectives = comm.collective_counts()
    ref_ids, ref_logp = ctc_first_prune(logits, k=P13_PRUNE_K)
    full = torch.log_softmax(logits, dim=-1)
    out = p13_prune_gate(label, ids, logp, ref_ids, ref_logp, full)
    out["collectives"] = collectives
    out["ms_sharded"] = time_ms(lambda: ctc_first_prune_sharded(
        logits, mesh, "tp", k=P13_PRUNE_K), 5)
    out["ms_whole"] = time_ms(lambda: ctc_first_prune(logits,
                                                      k=P13_PRUNE_K), 5)
    print(f"{label}: {P13_PRUNE_SHAPE} k={P13_PRUNE_K}: {out}", flush=True)
    return out


def p13_kernel_cases(gen) -> list:
    """#1, #2 and #3 (fp32, the recognizer's) at the heads a rank holds
    at tp 2 and 4: paraformer_large's d 512 over 4 heads of 128; and #1
    at 13g's whole-heads forward's shape (3 heads of 128, T 1000)."""
    runs = []
    for tp in (2, 4):
        for name, shape in (
                ("mh_flash_attention", (16, 1024, 1024, 512 // tp, 4 // tp)),
                ("_attention_ss", (1, 4 // tp, 3072, 128)),
                ("_attention_flash", (1, 4 // tp, 5120, 128))):
            r = dict(kernel_case(name, shape, "float32", gen), name=name,
                     path=f"tp{tp}: {4 // tp} heads a rank")
            print_case(name, r, f" (tp {tp}: {4 // tp} heads a rank)")
            runs.append(r)
    # 13g's whole-heads model: all P13G_HEADS heads on every rank
    shape = (P13G_BATCH, 1000, 1000, 128 * P13G_HEADS, P13G_HEADS)
    r = dict(kernel_case("mh_flash_attention", shape, "float32", gen),
             name="mh_flash_attention",
             path=f"whole heads: {P13G_HEADS} a rank")
    print_case("mh_flash_attention", r, f" (whole: {P13G_HEADS} heads a "
               "rank)")
    runs.append(r)
    return runs


def p13_svs(mesh, label: str) -> dict:
    """The multi-card SenseVoice: sensevoice_small's widths with vocab
    P13_SVS_VOCAB and P13_SVS_BLOCKS of depth, whole and sharded over
    the mesh's tp, on P13_SVS_SEGMENTS x 60 s: logits, greedy ids, the
    sharded prune against the whole prune, the greedy recognizers and
    the beam ones with a context (texts counted; the beam's collectives
    gated: candidates exchanged, never the logits)."""
    import dataclasses

    import torch

    from asr2pass_tpu_torch.config import sensevoice_small
    from asr2pass_tpu_torch.decode.context_graph import ContextGraph
    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.frontend.lfr import lfr_len
    from asr2pass_tpu_torch.models import sensevoice
    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel import comm
    from asr2pass_tpu_torch.parallel.ctc_shard import (
        ctc_first_prune, ctc_first_prune_sharded)
    from asr2pass_tpu_torch.parallel.sharding import shard_params
    from asr2pass_tpu_torch.runtime.sensevoice_asr import SenseVoiceOffline
    from asr2pass_tpu_torch.runtime.streaming_frontend import (
        offline_frontend_device)
    from asr2pass_tpu_torch.text.vocab import Vocab

    cfg = sensevoice_small(P13_SVS_VOCAB)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, num_blocks=P13_SVS_BLOCKS[0]))
    dev = p13_device()
    with torch.no_grad():
        model = sensevoice.init(cfg, torch.Generator().manual_seed(5), "cpu",
                                tp_blocks=P13_SVS_BLOCKS[1]).to(dev)
    local = shard_params(model, mesh)
    vocab = Vocab(cjk_tokens(P13_SVS_VOCAB))
    segs = [synth_audio(60.0, 340 + i) for i in range(P13_SVS_SEGMENTS)]
    recs = {"whole": SenseVoiceOffline(model, cfg, vocab),
            "tp": SenseVoiceOffline(model, cfg, vocab, tp_mesh=mesh)}
    res = {"whole": recs["whole"].recognize_batch(segs)}
    torch.cuda.synchronize()
    att.reset_launch_counts()
    res["tp"] = recs["tp"].recognize_batch(segs)
    torch.cuda.synchronize()
    tp_launches = att.launch_counts()
    # the beam with a context: the sharded prune with the context units'
    # log-probs, in the recognizer
    tokens = cjk_tokens(P13_SVS_VOCAB)
    ctx = ContextGraph().build({"".join(tokens[100 + 2 * j: 102 + 2 * j]):
                                20.0 for j in range(4)})
    beams = {k: SenseVoiceOffline(model, cfg, vocab, beam=4, context=ctx,
                                  tp_mesh=m)
             for k, m in (("whole", None), ("tp", mesh))}
    beam_res = {"whole": beams["whole"].recognize_batch(segs)}
    comm.reset_collective_counts()
    beam_res["tp"] = beams["tp"].recognize_batch(segs)
    beam_collectives = comm.collective_counts()
    fcfg = cfg.frontend
    ns = [num_frames(len(s), fcfg) for s in segs]
    t_lfr = [lfr_len(n, fcfg.lfr_m, fcfg.lfr_n) for n in ns]
    feats = offline_frontend_device(segs, ns, 1024, fcfg, device=dev)
    b = len(segs)
    args = [torch.tensor(t_lfr, device=dev),
            torch.full((b,), cfg.lid_dict["auto"], device=dev),
            torch.full((b,), cfg.textnorm_dict["withitn"], device=dev)]
    with torch.inference_mode():
        ref = sensevoice.apply(model, cfg, feats, *args)
        comm.reset_collective_counts()
        got = sensevoice.apply(local, cfg, feats, *args)
        fwd = comm.collective_counts()
        # one forward, the greedy ids' two all-gathers of [B, T], the
        # prune's two all-reduces and two all-gathers and the context
        # units' all-reduce: no all-gather of the logits
        want = dict(fwd, all_reduce=fwd["all_reduce"] + 3,
                    all_gather=fwd["all_gather"] + 4)
        if beam_collectives != want:
            fail(f"{label}: the beam's collectives {beam_collectives}, "
                 f"expected {want}")
        gate = p13_ctc_gate(label, ref.logits.float().cpu(),
                            sensevoice.whole_logits(got).float().cpu(),
                            ref.lengths.tolist())
        ids, logp = ctc_first_prune_sharded(got.logits, mesh, "tp",
                                            k=P13_PRUNE_K)
        rid, rlp = ctc_first_prune(ref.logits, k=P13_PRUNE_K)
        prune = p13_prune_gate(label, ids, logp, rid, rlp,
                               torch.log_softmax(ref.logits.float(), -1))
    differ = p13_texts_gate(label, res["whole"], res["tp"], exact=False)
    beam_differ = p13_texts_gate(label, beam_res["whole"], beam_res["tp"],
                                 exact=False)
    out = dict(gate, prune=prune, **differ, beam=beam_differ,
               beam_collectives=beam_collectives,
               launches_tp_recognizer=tp_launches,
               heads_per_rank=local.encoder.first.att.qkv.w.shape[1] // 3
               // (cfg.encoder.output_size // cfg.encoder.attention_heads),
               vocab_per_rank=local.ctc.w.shape[1])
    print(f"{label}: {out}", flush=True)
    return out


def p13_rank(rank: int, world: int, tmp: str, model_dir: str) -> None:
    """One NCCL rank of the multi-card phase 13 (a card each): the
    recognizers at tp 2 and 4, the sequence-parallel one over all ranks,
    the one given both meshes over all ranks, a 3-head model's at tp over
    all ranks (its attention whole), dp x tp training and SenseVoice's
    sharded prune; its numbers go to <tmp>/p13_rank<rank>.json."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from asr2pass_tpu_torch.parallel.sharding import make_mesh
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    init_distributed(f"file://{tmp}/p13_multi_rdv", world, rank,
                     device="cuda", timeout_s=P13_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        bundle = load_offline_bundle(model_dir)
        segs, long_seg = p13_audio()
        out = {"rank": rank, "card": torch.cuda.get_device_name()}
        whole = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                                  cmvn=bundle.cmvn)
        # a fresh process: every bucket warmed before the timed runs
        whole.recognize_batch(segs)
        ref = p13_run(whole, segs)
        for tp in (2, 4):
            if world % tp:
                continue
            out[f"tp{tp}"] = p13_recognizers(
                bundle, whole, ref, make_mesh(world, tp=tp), segs,
                f"13 rank {rank} tp {tp}")
        sp_mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("sp",))
        out[f"sp{world}"] = p13_sp(bundle, whole, sp_mesh, long_seg,
                                   f"13 rank {rank} sp {world}")
        sp_res = out[f"sp{world}"].pop("results")
        short = P13_SEGMENTS + 1
        out[f"tpsp{world}"] = p13_tpsp(
            bundle, ref["res"][:short], sp_res, make_mesh(world, tp=world),
            sp_mesh, segs[:short] + [long_seg],
            f"13 rank {rank} tp {world} x sp {world}")
        out[f"tpsp{world}"].pop("launches_by_dtype")
        out[f"heads_tp{world}"] = p13_heads_recognizer(
            world, segs[:P13_SEGMENTS], f"13 rank {rank} 3 heads at tp "
            f"{world}")
        if world % 2 == 0:
            out["train"] = p13_train(
                bundle, make_mesh(world, tp=2),
                f"13 rank {rank} dp {world // 2} x tp 2")
        out[f"svs_tp{world}"] = p13_svs(
            make_mesh(world, tp=world),
            f"13 rank {rank} SenseVoice tp {world}")
        for key in ("tp2", "tp4", f"heads_tp{world}"):
            out.get(key, {}).pop("launches_by_dtype", None)
        with open(os.path.join(tmp, f"p13_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase13(tmp: str, gen, card: str, one_card: bool = True):
    """Phase 13. On a world-size-1 NCCL group in this process: 13a the
    tensor-parallel recognizer, 13b the sequence-parallel one, 13g the
    recognizer given both meshes and phase 11a's int8 trees sharded
    (every unit whole), 13c the sharded training step, 13d the sharded
    prune, each against the unsharded port on the card, 13e the kernels
    at the heads a rank holds at tp 2 and 4; and, beside them, 13g's
    whole heads, a 3-head model at tp 2 over two gloo ranks on the card
    (one_card=False
    leaves 13a-13e and 13g out). With two or more cards, 13f: one NCCL
    rank a card (p13_rank). Returns ({path: launches}, numbers)."""
    import torch

    numbers = {"card": card, "torch": torch.__version__}
    launches = {}
    if one_card:
        numbers.update(p13_one_card(tmp, gen))
        launches["tp13"] = numbers["13a"].pop("launches_by_dtype")
        g = numbers["13g"]
        launches["tpsp13g"] = g["tpsp"].pop("launches_by_dtype")
        launches["int8_tp13g"] = g["int8"].pop("launches_by_dtype")
        launches["heads13g"] = {
            k: {d: g["heads"][0]["launches_tp"].get(k, {}).get(d, 0)
                for d in v} for k, v in launches["tp13"].items()}
    world = torch.cuda.device_count()
    if world > 1:
        import torch.multiprocessing as mp

        with CLOCK.phase("13f"):
            mp.spawn(p13_rank, args=(world, tmp, os.path.join(tmp, "model")),
                     nprocs=world, join=True)
            numbers["13f"] = []
            for r in range(world):
                with open(os.path.join(tmp, f"p13_rank{r}.json")) as f:
                    numbers["13f"].append(json.load(f))
    return launches, numbers


def p13_one_card(tmp: str, gen) -> dict:
    """13a-13e (phase13)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from asr2pass_tpu_torch.parallel.sharding import make_mesh
    from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle
    from asr2pass_tpu_torch.runtime.offline_asr import ParaformerOffline

    heads = p13g_heads_start(tmp)
    with CLOCK.part("build"):
        init_distributed(f"file://{tmp}/p13_rdv", 1, 0, device="cuda",
                         timeout_s=P13_TIMEOUT_S)
        mesh = make_mesh(1, tp=1)
        sp_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
        bundle = load_offline_bundle(os.path.join(tmp, "model"))
        segs, long_seg = p13_audio()
        whole = ParaformerOffline(bundle.params, bundle.cfg, bundle.vocab,
                                  cmvn=bundle.cmvn)
    numbers = {}
    try:
        with CLOCK.phase("13a"):
            ref = p13_run(whole, segs)
            numbers["13a"] = p13_recognizers(bundle, whole, ref, mesh, segs,
                                             "13a tp 1")
        with CLOCK.phase("13b"):
            numbers["13b"] = p13_sp(bundle, whole, sp_mesh, long_seg,
                                    "13b sp 1")
        sp_res = numbers["13b"].pop("results")
        with CLOCK.phase("13g"):
            short = P13_SEGMENTS + 1        # 16 x 60 s and the 150 s
            numbers["13g"] = {
                "tpsp": p13_tpsp(bundle, ref["res"][:short], sp_res, mesh,
                                 sp_mesh, segs[:short] + [long_seg],
                                 "13g tp 1 x sp 1"),
                "int8": p13_int8_whole(bundle, mesh, gen, "13g int8 tp 1")}
        del ref
        with CLOCK.phase("13c"):
            numbers["13c"] = p13_train(bundle, mesh, "13c dp 1 x tp 1")
        with CLOCK.phase("13d"):
            numbers["13d"] = p13_prune(mesh, gen, "13d prune tp 1")
    finally:
        dist.destroy_process_group()
    with CLOCK.phase("13e"):
        numbers["13e"] = p13_kernel_cases(gen)
    del bundle, whole
    torch.cuda.empty_cache()
    with CLOCK.phase("13g-heads"):
        numbers["13g"]["heads"] = p13g_heads_join(heads, tmp)
    return numbers


def p13_numbers(p13: dict) -> dict:
    """Phase 13's numbers for its JSON line (the kernel cases go on the
    kernels line)."""
    keep = ("shape", "path", "ms", "device_ms", "bound_ms", "plain_ms",
            "library_ms")
    return dict(p13, **{"13e": [{k: r[k] for k in ("name",) + keep}
                                for r in p13.get("13e", [])]})


def phase13_alone(gen, card: str, t_start: float, one_card: bool) -> int:
    """`chip_smoke.py --phase 13`: the kernels' build, phase 3's model dir,
    then phase 13 alone (its multi-card part on every visible card);
    `--phase 13f`: its multi-card part alone."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        with CLOCK.part("build"):
            save_model_dir(os.path.join(tmp, "model"), gen)
        with CLOCK.phase("13"):
            _, p13 = phase13(tmp, gen, card, one_card)
    print(f"phase 13: {json.dumps(p13_numbers(p13))}")
    print(f"phase seconds: {json.dumps(CLOCK.rows)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


P14_CAPACITY = 4           # the Paraformer servers' --engine-capacity
P14_CONNECTIONS = 4        # paced 2pass connections a server, one burst each
P14_BURST_S = 10.0         # each after 2 s of silence, 2 s of silence after
P14_STAGGER_S = 3.0        # between the connections' starts: longer than a
                           # pass-2 lane call, so each segment decodes alone
P14_UPLOADS = (150.0, 270.0)   # through #2 and #3 (one VAD segment each)
P14_MEM_UPLOADS = 8        # 10 s uploads, each with hotwords of its own
P14_MEM_SECONDS = 10.0
P14_MEM_SHARE = 0.25       # growth over 8 uploads, of one model's bytes
P14_SVS_SECONDS = 60.0
P14_DIST_TIMEOUT_S = 60    # the servers' --dist-timeout
P14_WAIT_S = 600           # a server's start (its models loaded)
P14_DEVICE = "cuda"        # the servers' --device
P14_SP_SECONDS = 300.0     # 14c: T ~ 5000 LFR frames, past the threshold
P14_SP_THRESHOLD = 4096
P14_TPS = (2, 4)
P14_CPU_SCALE = 1.0        # audio lengths (the CPU rehearsal shrinks them)
# 14a-lane: four streams through in-process engines at tp 1 and tp 0, fed
# in lockstep, so both lane calls carry the same batches: each stream's two
# bursts (s) end together, at P14_LANE_ENDS, so one lane call decodes four
# segments in three chunks (two rows in one; c0 hotworded). Segments of
# bucket 64 and 128 are gathered from the audio ring (a 256 one is past
# its freshness margin and takes the samples); the second bursts end past
# the ring's 32.8 s, so their gathers wrap
P14_LANE_BURSTS = ((2.5, 6.0), (6.0, 2.5), (6.0, 2.5), (12.0, 6.0))
P14_LANE_ENDS = (18.0, 34.0)
P14_LANE_TAIL_S = 2.5
P14_LANE_FEATS_TOL = 1e-3  # ring-gathered features against the samples'


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class P14Server:
    """A server process (`python -m ...run_server`, or the supervisor) in
    a session of its own, so that stop() ends its worker ranks too; its
    output goes to <tmp>/p14_<name>.log."""

    def __init__(self, tmp: str, name: str, argv: list, port: int = None,
                 module: str = "asr2pass_tpu_torch.server.run_server"):
        self.name, self.port = name, port
        self.log = os.path.join(tmp, f"p14_{name}.log")
        env = dict(os.environ, PYTHONPATH=REPO)
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        self.t0 = time.perf_counter()

    @classmethod
    def server(cls, tmp: str, name: str, flags: list):
        port = free_port()
        return cls(tmp, name, ["--host", "127.0.0.1", "--port", str(port),
                               "--device", P14_DEVICE, "--dist-timeout",
                               str(P14_DIST_TIMEOUT_S), *flags], port)

    def tail(self, n: int = 3000) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()[-n:]

    def wait_up(self, port: int = None, proc=None):
        """Until `port` (this server's by default) takes connections; fail
        when the process ends first."""
        import socket

        port = port or self.port
        deadline = time.perf_counter() + P14_WAIT_S
        while time.perf_counter() < deadline:
            if self.proc.poll() is not None:
                fail(f"14: {self.name} exited {self.proc.returncode}:\n"
                     f"{self.tail()}")
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                return time.perf_counter() - self.t0
            except OSError:
                time.sleep(0.2)
        fail(f"14: {self.name} not listening after {P14_WAIT_S} s:\n"
             f"{self.tail()}")

    def stop(self, timeout: float = 60.0):
        """SIGTERM, then the session's SIGKILL; returns the exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        return rc

    def left(self) -> bool:
        """Whether a process of this server's session is still alive."""
        try:
            os.killpg(self.proc.pid, 0)
            return True
        except ProcessLookupError:
            return False


async def p14_stats(port: int) -> dict:
    import websockets

    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(json.dumps({"action": "stats"}))
        return json.loads(await ws.recv())["stats"]


async def p14_upload(port: int, name: str, wave, **fields):
    """One offline upload; returns (text, timestamp string, seconds)."""
    t0 = time.perf_counter()
    _, msgs = await ws_client(
        port, name, s16_bytes(wave), "offline",
        first=reference_first_message("offline", name, **{
            "hotwords": "", **fields}))
    ms = [m for _, m in msgs]
    if len(ms) != 1 or ms[0]["mode"] != "offline" or not ms[0]["is_final"]:
        fail(f"14: upload {name} gave {ms}")
    return ms[0]["text"], ms[0].get("timestamp"), time.perf_counter() - t0


def p14_stream_view(msgs) -> dict:
    """What a 2pass connection's results carry, timing-free: the
    concatenated partials and each final's text and timestamps."""
    ms = [m for _, m in msgs]
    return {"partial": "".join(m["text"] for m in ms
                               if m["mode"] == "2pass-online"),
            "finals": [[m["text"], m.get("timestamp")] for m in ms
                       if m["mode"] == "2pass-offline"]}


def p14_check_stream(label: str, name: str, msgs, spans, stamps=True):
    """One is_final, the last message; one non-empty pass-2 result per
    burst (with timestamps where the pass 2 has them); partials."""
    ms = [m for _, m in msgs]
    finals = [i for i, m in enumerate(ms) if m.get("is_final")]
    offs = [m for m in ms if m["mode"] == "2pass-offline"]
    if (finals != [len(ms) - 1] or len(offs) != len(spans)
            or any(not m["text"] or ("timestamp" in m) != stamps
                   for m in offs)
            or not any(m["mode"] == "2pass-online" and m["text"]
                       for m in ms)):
        fail(f"14: {label} {name}: finals at {finals} of {len(ms)}, "
             f"{len(offs)} pass-2 results for {len(spans)} bursts: "
             f"{[m for m in ms if m['mode'] != '2pass-online']}")


def p14_agreement(got: list, want: list) -> dict:
    """How many connections' partials, finals and timestamps are equal,
    and where the first differing final text differs."""
    out = {"partials": 0, "finals": 0, "stamps": 0, "of": len(got),
           "first_diff": None}
    for g, w in zip(got, want):
        g, w = p14_stream_view(g), p14_stream_view(w)
        out["partials"] += g["partial"] == w["partial"]
        texts = ([f[0] for f in g["finals"]], [f[0] for f in w["finals"]])
        out["finals"] += texts[0] == texts[1]
        out["stamps"] += g["finals"] == w["finals"]
        if texts[0] != texts[1] and out["first_diff"] is None:
            a, b = "".join(texts[0]), "".join(texts[1])
            k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            out["first_diff"] = [k, len(a), len(b)]
    return out


def p14_launch_delta(before: dict, after: dict) -> dict:
    return {name: {dt: after[name][dt] - before.get(name, {}).get(dt, 0)
                   for dt in by} for name, by in after.items()}


def p14_dirs(tmp: str) -> dict:
    return {k: os.path.join(tmp, k)
            for k in ("hotword", "online", "vad", "punc", "svs")}


def p14_flags(d: dict, svs: bool = False) -> list:
    """A Paraformer server with the engine, or a SenseVoice one without:
    its 2pass connection runs a session, pass 2 at one segment a call."""
    flags = ["--model-dir", d["hotword"], "--online-model-dir", d["online"],
             "--vad-dir", d["vad"], "--punc-dir", d["punc"]]
    if svs:
        return flags + ["--svs-dir", d["svs"]]
    return flags + ["--engine", "--engine-capacity", str(P14_CAPACITY)]


def p14_requests():
    """14a's requests: per paced connection (its audio and burst spans,
    its first message), the memory gate's uploads (audio, hotwords), the
    long uploads."""
    import numpy as np

    quiet = np.zeros(2 * FS, np.float32)
    streams = [(s16_bytes(np.concatenate(
        [quiet, synth_audio(P14_BURST_S, 1400 + i), quiet])),
        [(2000, 2000 + int(P14_BURST_S * 1000))])
        for i in range(P14_CONNECTIONS)]
    firsts = [reference_first_message(
        "2pass", f"c{i}", hotwords=json.dumps(hotword_list(5, 140))
        if i == 0 else "") for i in range(P14_CONNECTIONS)]
    mem = [(synth_audio(P14_MEM_SECONDS * P14_CPU_SCALE, 140 + i),
            json.dumps(hotword_list(3, 150 + i)))
           for i in range(P14_MEM_UPLOADS)]
    longs = [synth_audio(s * P14_CPU_SCALE, 160 + k)
             for k, s in enumerate(P14_UPLOADS)]
    return streams, firsts, mem, longs


async def p14_uploads(port: int, longs):
    """One server's long uploads (one VAD segment each), one at a time."""
    return [await p14_upload(port, f"long{k}", w, vad_max_len=400000)
            for k, w in enumerate(longs)]


async def p14_clients(port: int, streams, firsts,
                      stagger: float = P14_STAGGER_S):
    """One server's paced connections, `stagger` s apart."""
    import asyncio

    return await asyncio.gather(*[
        ws_client(port, f"c{i}", data, "2pass", PACE_S, i * stagger,
                  first=first)
        for i, ((data, _), first) in enumerate(zip(streams, firsts))])


async def p14_drive(port: int, streams, firsts, longs):
    """A server's long uploads, then its paced connections. Returns
    (clients, uploads)."""
    ups = await p14_uploads(port, longs)
    return await p14_clients(port, streams, firsts), ups


def p14_supervisor_yaml(tmp: str, d: dict, ports) -> str:
    """14b's fleet: a 2pass engine server and an offline server with
    tp_devices 1, both on card 0."""
    where = ("    cpu: true\n" if P14_DEVICE == "cpu"
             else "    device: 0\n")
    common = (f"    model_dir: {d['hotword']}\n    vad_dir: {d['vad']}\n"
              f"    punc_dir: {d['punc']}\n    itn: true\n" + where)
    text = ("servers:\n"
            f"  - name: p14-2pass\n    port: {ports[0]}\n    mode: 2pass\n"
            + common + f"    online_model_dir: {d['online']}\n"
            f"    engine: true\n    engine_capacity: {P14_CAPACITY}\n"
            f"  - name: p14-offline\n    port: {ports[1]}\n"
            "    mode: offline\n" + common + "    tp_devices: 1\n"
            "restart:\n  autorestart: true\n  startretries: 3\n")
    path = os.path.join(tmp, "p14_servers.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def p14_child_pid(sup: "P14Server", name: str, nth: int = 0) -> int:
    marker = f"started {name} on port "
    lines = [ln for ln in sup.tail(100000).splitlines()
             if ln.startswith(marker)]
    return int(lines[nth].split("(pid ")[1].rstrip(")"))


def p14_start(tmp: str) -> dict:
    """Start 14a's servers and 14b's supervisor without waiting for them
    (the whole script starts them before phase 13, whose card work then
    hides their start-up)."""
    d = p14_dirs(tmp)
    ports = (free_port(), free_port())
    return {"servers": {
                "tp1": P14Server.server(tmp, "tp1", p14_flags(d) + [
                    "--tp-devices", "1"]),
                "tp0": P14Server.server(tmp, "tp0", p14_flags(d)),
                "svs_tp1": P14Server.server(tmp, "svs_tp1", p14_flags(
                    d, svs=True) + ["--tp-devices", "1"]),
                "svs_tp0": P14Server.server(tmp, "svs_tp0",
                                            p14_flags(d, svs=True))},
            "ports": ports,
            "sup": P14Server(tmp, "supervisor", [
                "--config", p14_supervisor_yaml(tmp, d, ports)],
                module="asr2pass_tpu_torch.server.run_all_servers")}


def p14_stop(fleet: dict) -> dict:
    """Stop every process of p14_start's fleet; their exit codes."""
    rcs = {k: s.stop() for k, s in fleet["servers"].items()}
    rcs["supervisor"] = fleet["sup"].stop()
    return rcs


def phase14(tmp: str, card: str, one_card: bool = True, fleet=None):
    """Phase 14: serving on torch.distributed through the port's launcher
    and supervisor, as processes. 14a: on one card, --tp-devices 1 (rank 0
    through the fan-out, no workers) against --tp-devices 0, each on 9a's
    dir (paraformer_large with timestamps and the hotword block) with
    phase 7's dirs, and SenseVoice (9b's dir) the same way; 14b: the
    supervisor with a 2pass engine entry and an offline entry at
    tp_devices 1 on card 0, a killed child restarted, SIGTERM. With two
    or more cards, 14c: --tp-devices 2 and 4 with real worker ranks, an
    --sp-devices server on a 300 s upload, and a killed worker.
    one_card=False runs 14c alone; `fleet`, p14_start's, when it has
    started 14a's servers. Returns ({path: launches}, numbers)."""
    import torch

    d = p14_dirs(tmp)
    numbers = {"card": card}
    launches = {}
    torch.cuda.empty_cache()
    if one_card:
        with CLOCK.phase("14ab"):
            launches["tp14"], numbers["14a"], numbers["14b"] = p14_one_card(
                tmp, d, card, fleet or p14_start(tmp))
        with CLOCK.phase("14a-lane"):
            launches["lane14"], numbers["14a-lane"] = p14_lane(tmp, d, card)
    cards = torch.cuda.device_count()
    if cards > 1:
        with CLOCK.phase("14c"):
            numbers["14c"] = p14_multi_card(tmp, d, card, cards)
    return launches, numbers


def p14_one_card(tmp: str, d: dict, card: str, fleet: dict):
    """14a and 14b (phase14) on p14_start's fleet, which they stop.
    Returns (tp 1 server's launches, numbers of 14a, of 14b)."""
    import asyncio
    import signal

    t0 = time.perf_counter()
    streams, firsts, mem, longs = p14_requests()
    servers, ports, sup = fleet["servers"], fleet["ports"], fleet["sup"]
    a, b = {"card": card}, {"card": card}
    try:
        with CLOCK.part("build"):
            a["start_s"] = {k: s.wait_up() for k, s in servers.items()}
            b["start_s"] = [sup.wait_up(p) for p in ports]
        print(f"14: servers up, s since start {a['start_s']}, the "
              f"supervisor's {b['start_s']}", flush=True)
        port = {k: s.port for k, s in servers.items()}

        async def one_and_eight(p):
            """The memory gate's uploads on one server: allocated after
            the first and after all."""
            res, mems = [], []
            for i, (wave, hot) in enumerate(mem):
                res.append(await p14_upload(p, f"m{i}", wave, hotwords=hot))
                if i in (0, len(mem) - 1):
                    mems.append((await p14_stats(p)).get("memory"))
            return res, mems

        async def part0():
            return await asyncio.gather(*[
                p14_upload(p, f"b{k}", mem[0][0], hotwords=mem[0][1])
                for k, p in enumerate(ports)])

        async def part1():
            before = await asyncio.gather(*[p14_stats(port[k])
                                            for k in ("tp1", "tp0")])
            got = await asyncio.gather(one_and_eight(port["tp1"]),
                                       one_and_eight(port["tp0"]))
            return before, got

        # 14b: each entry answers once; a child killed then restarts while
        # 14a's traffic runs
        b0, b1 = asyncio.run(part0())
        killed = p14_child_pid(sup, "p14-offline")
        os.kill(killed, signal.SIGKILL)
        t_kill = time.perf_counter()
        t1 = time.perf_counter()
        before, (m1, m0) = asyncio.run(part1())
        a["memory_uploads_s"] = time.perf_counter() - t1

        async def part2():
            svs = [p14_drive(port[k], streams[:1], firsts[:1], [
                synth_audio(P14_SVS_SECONDS * P14_CPU_SCALE, 170)])
                for k in ("svs_tp1", "svs_tp0")]
            ups = await asyncio.gather(p14_uploads(port["tp1"], longs),
                                       p14_uploads(port["tp0"], longs))
            got = await asyncio.gather(
                p14_clients(port["tp1"], streams, firsts),
                p14_clients(port["tp0"], streams, firsts), *svs)
            stats = await asyncio.gather(*[p14_stats(port[k])
                                           for k in servers])
            return [(got[0], ups[0]), (got[1], ups[1])] + got[2:], dict(
                zip(servers, stats))

        t1 = time.perf_counter()
        (g1, g0, s1, s0), stats = asyncio.run(part2())
        a["traffic_s"] = time.perf_counter() - t1
        # 14b after the restart: the offline entry answers again
        while "restart 1/3" not in sup.tail(100000):
            if time.perf_counter() - t_kill > P14_WAIT_S:
                fail(f"14b: p14-offline not restarted:\n{sup.tail()}")
            time.sleep(0.2)
        sup.wait_up(ports[1])
        b["restart_s"] = time.perf_counter() - t_kill
        b2 = asyncio.run(p14_upload(ports[1], "b2", mem[0][0],
                                    hotwords=mem[0][1]))
    finally:
        rcs = p14_stop(fleet)
    print(f"14: exit codes {rcs}", flush=True)
    if any(rc != 0 for rc in rcs.values()) or any(
            s.left() for s in list(servers.values()) + [sup]):
        fail(f"14: a server did not stop cleanly: {rcs}")
    # -- 14a gates ----------------------------------------------------------
    for label, (clients, ups) in (("tp1", g1), ("tp0", g0)):
        for i, ((_, msgs), (_, spans)) in enumerate(zip(clients, streams)):
            p14_check_stream(label, f"c{i}", msgs, spans)
    # tp 1 is bit-equal to tp 0 where both decode the same batches: every
    # upload (one segment a forward), the SenseVoice session, and the
    # paced connections, whose segments end P14_STAGGER_S apart, so that
    # each lane call decodes one (with the long uploads running at the
    # same time, most connections' results differed between the two)
    ups = {k: [u[:2] for u in g[1]] for k, g in (("tp1", g1), ("tp0", g0))}
    if ups["tp1"] != ups["tp0"] or not all(u[0] and u[1]
                                           for u in ups["tp1"]):
        fail(f"14a: the long uploads differ at tp 1 or are empty: {ups}")
    if [r[:2] for r in m1[0]] != [r[:2] for r in m0[0]] or not all(
            r[0] for r in m1[0]):
        fail(f"14a: the uploads differ or are empty: {m1[0]} {m0[0]}")
    p14_check_stream("svs_tp1", "c0", s1[0][0][1], streams[0][1],
                     stamps=False)
    if s1[1][0][:2] != s0[1][0][:2] or not s1[1][0][0]:
        fail(f"14a: SenseVoice's upload at tp 1 differs from tp 0: "
             f"{s1[1][0][:2]} {s0[1][0][:2]}")
    a["streams_equal"] = p14_agreement(
        [m for _, m in g1[0]] + [s1[0][0][1]],
        [m for _, m in g0[0]] + [s0[0][0][1]])
    if any(a["streams_equal"][k] != a["streams_equal"]["of"]
           for k in ("partials", "finals", "stamps")):
        fail(f"14a: the paced connections differ at tp 1 from tp 0: "
             f"{a['streams_equal']}")
    fan = stats["tp1"].get("fanout") or {}
    if fan.get("shards") != ["asr"] or stats["svs_tp1"].get(
            "fanout", {}).get("shards") != ["svs"] or "fanout" in stats["tp0"]:
        fail(f"14a: shards held {fan.get('shards')}, "
             f"{stats['svs_tp1'].get('fanout')}")
    mem1 = m1[1]
    a["memory"] = {"tp1": mem1, "tp0": m0[1]}
    if P14_DEVICE != "cpu":
        from asr2pass_tpu_torch.runtime.model_zoo import load_offline_bundle

        nbytes = sum(p.numel() * p.element_size() for p in
                     load_offline_bundle(d["hotword"]).params.values())
        grew = mem1[1]["max_allocated"] - mem1[0]["max_allocated"]
        a["memory"]["model_bytes"] = nbytes
        a["memory"]["grew_after_8"] = grew
        if grew > P14_MEM_SHARE * nbytes:
            fail(f"14a: peak memory grew {grew} B over {P14_MEM_UPLOADS} "
                 f"uploads with their own recognizers ({nbytes} B a model)")
    delta = p14_launch_delta(before[0].get("launches", {}),
                             stats["tp1"].get("launches", {}))
    a["launches"] = {"tp1": delta, "tp0": p14_launch_delta(
        before[1].get("launches", {}), stats["tp0"].get("launches", {})),
        "svs_tp1_since_start": stats["svs_tp1"].get("launches"),
        "svs_tp0_since_start": stats["svs_tp0"].get("launches")}
    # latencies: the paced connections' partials and finals, the tick
    for k, (clients, _) in (("tp1", g1), ("tp0", g0)):
        partial, final = [], []
        for (sends, msgs), (_, spans) in zip(clients, streams):
            p, f = server_latencies(sends, msgs, spans)
            partial += p
            final += f
        st = stats[k]["stages"]
        a[k] = {"partial_ms_p50_p95": [_pct(partial, 50), _pct(partial, 95)],
                "final_ms_p50_p95": [_pct(final, 50), _pct(final, 95)],
                "tick_ms_p50_p95": [st["tick"]["p50_ms"],
                                    st["tick"]["p95_ms"]]
                if "tick" in st else None,
                "p2_recognize_ms_p50_p95": [
                    st["p2_recognize"]["p50_ms"], st["p2_recognize"]["p95_ms"]]
                if "p2_recognize" in st else None,
                "uploads_s": [u[2] for u in (g1 if k == "tp1" else g0)[1]]}
    a["fanout"] = {k: {f: stats[k]["fanout"][f] for f in (
        "calls", "broadcasts", "bytes", "broadcasts_a_call", "bytes_a_call",
        "lock_wait_ms", "pings")} for k in ("tp1", "svs_tp1")}
    print(f"14a: tp 1 = tp 0 on the "
          f"{', '.join(f'{s:.0f}' for s in P14_UPLOADS)} s uploads, "
          f"{P14_MEM_UPLOADS} uploads with their own hotwords and "
          f"SenseVoice's upload, and on {P14_CONNECTIONS} paced "
          f"connections (c0 hotworded) and SenseVoice's, each one final a "
          f"burst: {json.dumps(a['streams_equal'])}; fan-out "
          f"{json.dumps(a['fanout'])}; "
          f"memory {json.dumps(a['memory'])}; launches {a['launches']}; "
          f"tp 1 {a['tp1']}, tp 0 {a['tp0']} on {card}", flush=True)
    if P14_DEVICE != "cpu":
        want = [("mh_flash_attention", "float32"), ("_attention_ss",
                 "float32"), ("_attention_flash", "float32")]
        if any(delta.get(n, {}).get(dt, 0) <= 0 for n, dt in want):
            fail(f"14a: the tp 1 server's launches {delta}")
    # -- 14b gates ----------------------------------------------------------
    b.update(killed_pid=killed, results_equal=[
        b0[:2] == m1[0][0][:2], b1[:2] == m1[0][0][:2],
        b2[:2] == m1[0][0][:2]])
    log = sup.tail(100000)
    if not all(b["results_equal"]) or log.count("restart ") != 1:
        fail(f"14b: results {b['results_equal']}, restarts "
             f"{log.count('restart ')}:\n{log[-3000:]}")
    pids = [int(ln.split("(pid ")[1].rstrip(")")) for ln in log.splitlines()
            if ln.startswith("started ")]
    for pid in pids:
        try:
            os.kill(pid, 0)
            fail(f"14b: process {pid} is left after SIGTERM")
        except ProcessLookupError:
            pass
    b["children"] = len(pids)
    print(f"14b: the supervisor's 2pass and tp-1 offline entries answered "
          f"as 14a; p14-offline killed, restarted once in "
          f"{b['restart_s']:.1f} s and answered again; SIGTERM left none of "
          f"its {len(pids)} processes; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return delta, a, b


def p14_lane_waves():
    """14a-lane's streams (P14_LANE_BURSTS ending at P14_LANE_ENDS), on
    the PCM grid a client's s16 frames give."""
    import numpy as np

    waves = []
    for i, bursts in enumerate(P14_LANE_BURSTS):
        parts, at = [], 0.0
        for k, (sec, end) in enumerate(zip(bursts, P14_LANE_ENDS)):
            parts += [np.zeros(int((end - sec - at) * FS), np.float32),
                      synth_audio(sec, 1500 + 10 * i + k)]
            at = end
        parts.append(np.zeros(int(P14_LANE_TAIL_S * FS), np.float32))
        w = np.concatenate(parts)
        waves.append(np.round(np.clip(w, -1, 1) * 32767).astype(np.float32)
                     / 32768.0)
    return waves


def p14_lane_run(models, waves, hw_emb, chunks=None) -> list:
    """The streams through a StreamEngine (pass 2 in the tick) in 600 ms
    messages, one a stream a tick, until drained; per stream its
    partials and [final, timestamps]. With `chunks`, each lane chunk's
    ring-gathered features are held against the front-end on the
    segments' samples: (rows, bb, bucket, wrapped, max_abs_err, or None
    for a chunk that took the samples) appended."""
    import numpy as np

    from asr2pass_tpu_torch.frontend.fbank import num_frames
    from asr2pass_tpu_torch.frontend.lfr import lfr_len
    from asr2pass_tpu_torch.runtime import streaming_frontend as sf
    from asr2pass_tpu_torch.runtime.engine import StreamEngine

    eng = StreamEngine(models, capacity=P14_CAPACITY)
    if chunks is not None:
        ring_override = eng._ring_feats_override
        asr = eng.offline.asr
        fcfg, (means, vars_) = asr.cfg.frontend, asr.cmvn

        def checked(pairs):
            inner = ring_override(pairs)
            frames = [fr for _, _, fr in pairs]

            def override(idxs, bucket, bb):
                feats = inner(idxs, bucket, bb)
                need = sf.offline_window_samples(fcfg, bucket)
                wrapped = any(frames[i].samp_start % eng._ring_samples
                              + need > eng._ring_samples for i in idxs)
                if feats is None:
                    chunks.append((len(idxs), bb, bucket, wrapped, None))
                    return None
                ref = sf.offline_frontend_device(
                    [frames[i].data for i in idxs],
                    [num_frames(len(frames[i].data), fcfg) for i in idxs],
                    bucket, fcfg, means, vars_, batch_b=bb,
                    device=asr.device)
                err = 0.0
                for row, i in enumerate(idxs):
                    n = lfr_len(num_frames(len(frames[i].data), fcfg),
                                fcfg.lfr_m, fcfg.lfr_n)
                    err = max(err, float((feats[row, :n] - ref[row, :n])
                                         .abs().max()))
                chunks.append((len(idxs), bb, bucket, wrapped, err))
                return feats

            return override

        eng._ring_feats_override = checked
    sids = [eng.open(hw_emb=hw_emb if i == 0 else None)
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
    deadline = time.perf_counter() + 120
    while not (all(eng.drained(s) for s in sids)
               and not eng.has_inflight()):
        if time.perf_counter() > deadline:
            fail("14a-lane: the engine did not drain")
        eng.step()
        for sid in sids:
            out[sid] += eng.poll(sid)
    eng.shutdown()
    return [{"partial": "".join(r["text"] for r in out[s]
                                if r["mode"] == "2pass-online"),
             "finals": [[r["text"], r.get("timestamp")] for r in out[s]
                        if r["mode"] == "2pass-offline"]}
            for s in sids]


def p14_lane(tmp: str, d: dict, card: str):
    """14a-lane (phase14): the pass-2 lane at tp 1 (through the fan-out,
    its ring features broadcast) against tp 0 on the same batches: four
    streams fed in lockstep to in-process engines on one world-size-1
    group, so that each lane call carries four segments in three chunks.
    Gates: every partial, final and timestamp equal; a call broadcast two
    or more chunks' features, one of two rows or more; a gather wrapped
    the ring, and every chunk's ring features equal the front-end's on the
    samples within P14_LANE_FEATS_TOL. Returns (tp 1's launches,
    numbers)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from asr2pass_tpu_torch.ops import attention as att
    from asr2pass_tpu_torch.parallel.multihost import init_distributed
    from asr2pass_tpu_torch.parallel.sharding import make_mesh
    from asr2pass_tpu_torch.server.run_server import build_models, parser

    t0 = time.perf_counter()
    waves = p14_lane_waves()
    with CLOCK.part("build"):
        init_distributed(f"file://{tmp}/p14_rdv", 1, 0, device=P14_DEVICE,
                         timeout_s=P14_DIST_TIMEOUT_S)
    try:
        with CLOCK.part("build"):
            m0 = build_models(parser().parse_args(
                p14_flags(d) + ["--device", P14_DEVICE]))
            m1 = dataclasses.replace(m0, tp_mesh=make_mesh(1, tp=1))
            hw = m0.compile_hotwords(hotword_list(5, 140))
        want = p14_lane_run(m0, waves, hw)
        fan, chunks = m1.fanout, []
        att.reset_launch_counts()
        got = p14_lane_run(m1, waves, hw, chunks)
        launches = att.launch_counts_by_dtype()
        stats = fan.stats()
        fan.stop()
    finally:
        dist.destroy_process_group()
    n = {"card": card, "equal": got == want,
         "finals": [len(g["finals"]) for g in got],
         "chunks_rows_bb_bucket_wrapped_err": chunks,
         "broadcasts_a_call_max": stats["broadcasts_a_call"]["max"],
         "calls": stats["calls"], "bytes": stats["bytes"],
         "s": time.perf_counter() - t0}
    print(f"14a-lane: {len(waves)} streams in lockstep, tp 1 (fan-out) "
          f"against tp 0: {json.dumps(n)}", flush=True)
    if not n["equal"]:
        fail(f"14a-lane: tp 1 differs from tp 0 on the same batches:\n"
             f"{got}\n{want}")
    if any(len(g["finals"]) != len(P14_LANE_ENDS) or not all(
            f[0] for f in g["finals"]) for g in got):
        fail(f"14a-lane: finals {got}")
    if (stats["broadcasts_a_call"]["max"] or 0) < 4 or max(
            c[0] for c in chunks) < 2:
        fail(f"14a-lane: no lane call broadcast two chunks, or none of two "
             f"rows: {chunks}, {stats}")
    ring = [c for c in chunks if c[4] is not None]
    if not any(c[3] for c in ring) or any(
            c[4] > P14_LANE_FEATS_TOL for c in ring):
        fail(f"14a-lane: no wrapped gather, or ring features off: {chunks}")
    if P14_DEVICE != "cpu" and launches.get("mh_flash_attention", {}).get(
            "float32", 0) <= 0:
        fail(f"14a-lane: launches {launches}")
    del m0, m1
    torch.cuda.empty_cache()
    return launches, n


def p14_multi_card(tmp: str, d: dict, card: str, cards: int):
    """14c (phase14): --tp-devices 2 and 4 with worker ranks on NCCL
    against an unsharded server on the same requests, an --sp-devices
    server on a 300 s upload, servers with --tp-devices and --sp-devices
    together (tp 4 x sp 4, tp 2 x sp 4) on a 150 s (TP) and the 300 s
    (SP) upload, and a worker killed under traffic."""
    import asyncio

    streams, firsts, _, longs = p14_requests()
    sp_wave = synth_audio(P14_SP_SECONDS * P14_CPU_SCALE, 180)
    tps = [tp for tp in P14_TPS if tp <= cards]
    sp = min(cards, 4)
    servers = {"tp0": P14Server.server(tmp, "c_tp0", p14_flags(d))}
    for tp in tps:
        servers[f"tp{tp}"] = P14Server.server(
            tmp, f"c_tp{tp}", p14_flags(d) + ["--tp-devices", str(tp)])
    servers[f"sp{sp}"] = P14Server.server(
        tmp, f"c_sp{sp}", p14_flags(d) + [
            "--sp-devices", str(sp), "--sp-threshold",
            str(P14_SP_THRESHOLD)])
    # both flags: tp = sp, and tp dividing sp
    tpsp = [(tp, sp) for tp in (sp, 2) if tp <= sp and sp % tp == 0
            and sp > 1]
    tpsp = list(dict.fromkeys(tpsp))
    for tp, n in tpsp:
        servers[f"tp{tp}sp{n}"] = P14Server.server(
            tmp, f"c_tp{tp}sp{n}", p14_flags(d) + [
                "--tp-devices", str(tp), "--sp-devices", str(n),
                "--sp-threshold", str(P14_SP_THRESHOLD)])
    c = {"card": card, "cards": cards}
    try:
        with CLOCK.part("build"):
            c["start_s"] = {k: s.wait_up() for k, s in servers.items()}

        async def drive(k):
            got = await p14_drive(servers[k].port, streams, firsts, longs)
            return got, await p14_stats(servers[k].port)

        async def sp_upload(k):
            return await p14_upload(servers[k].port, k, sp_wave,
                                    vad_max_len=400000)

        ref, _ = asyncio.run(drive("tp0"))
        sp_got = asyncio.run(sp_upload(f"sp{sp}"))
        sp_ref = asyncio.run(sp_upload("tp0"))
        tpsp_got = {}
        for tp, n in tpsp:
            k = f"tp{tp}sp{n}"
            tpsp_got[k] = (asyncio.run(p14_upload(
                servers[k].port, k, longs[0], vad_max_len=400000)),
                asyncio.run(sp_upload(k)),
                asyncio.run(p14_stats(servers[k].port)))
        results = {}
        for tp in tps:
            results[tp] = asyncio.run(drive(f"tp{tp}"))
        # a worker killed while two connections and an upload run
        victim = servers[f"tp{tps[0]}"]
        fault = p14_kill_worker(victim, streams, firsts, longs)
    finally:
        rcs = {k: s.stop() for k, s in servers.items()}
    want_up = [u[:2] for u in ref[1]]
    for tp, (got, st) in results.items():
        for i, ((_, msgs), (_, spans)) in enumerate(zip(got[0], streams)):
            p14_check_stream(f"tp{tp}", f"c{i}", msgs, spans)
        ups = [u[:2] for u in got[1]]
        if [u[0] for u in ups] != [u[0] for u in want_up]:
            fail(f"14c: tp {tp}'s upload texts differ from the unsharded "
                 "server's")
        c[f"tp{tp}"] = {
            "upload_stamps_moved": sum(a[1] != b[1]
                                       for a, b in zip(ups, want_up)),
            "streams_equal": p14_agreement([m for _, m in got[0]],
                                           [m for _, m in ref[0]]),
            "fanout": st.get("fanout"), "launches_rank0": st.get("launches")}
    n_sp, n_ref = (len(json.loads(x[1] or "[]")) for x in (sp_got, sp_ref))
    from asr2pass_tpu_torch.tools.compute_wer import align

    c["sp"] = {"tokens": n_sp, "tokens_unsharded": n_ref,
               "char_edits": align(list(sp_ref[0]), list(sp_got[0]))[1],
               "chars": len(sp_ref[0])}
    if n_sp != n_ref or not n_sp:
        fail(f"14c: the sp {sp} upload has {n_sp} tokens, the unsharded "
             f"{n_ref}")
    for k, (short, long_, st) in tpsp_got.items():
        n_long = len(json.loads(long_[1] or "[]"))
        c[k] = {"short_text_equal": short[0] == want_up[0][0],
                "short_stamps_equal": short[1] == want_up[0][1],
                "long_tokens": n_long,
                "long_char_edits_vs_sp": align(list(sp_got[0]),
                                               list(long_[0]))[1],
                "fanout": st.get("fanout"),
                "launches_rank0": st.get("launches")}
        if short[0] != want_up[0][0] or n_long != n_ref:
            fail(f"14c: {k}: the 150 s upload's text equal to the "
                 f"unsharded server's: {short[0] == want_up[0][0]}; the "
                 f"300 s upload {n_long} tokens, the unsharded {n_ref}")
    c["fault"] = fault
    c["exit_codes"] = rcs
    c["worker_launches"] = {k: p14_worker_launches(s) for k, s in
                            servers.items() if k.startswith("tp")}
    print(f"14c: {json.dumps(c)}", flush=True)
    if any(rc != 0 for k, rc in rcs.items() if k != f"tp{tps[0]}") or any(
            s.left() for s in servers.values()):
        fail(f"14c: servers did not stop cleanly: {rcs}")
    return c


def p14_worker_launches(server: "P14Server") -> dict:
    """{rank: the attention launches it logged on its way out}."""
    marker = ": attention launches "
    out = {}
    for ln in server.tail(10 ** 7).splitlines():
        if marker in ln and "rank " in ln:
            rank = ln.split("rank ")[1].split(":")[0]
            out[rank] = json.loads(ln.split(marker)[1])
    return out


def p14_kill_worker(server: "P14Server", streams, firsts, longs) -> dict:
    """Two paced connections and one upload on a server with worker
    ranks; its rank 1 killed 3 s in. The server must exit non-zero
    within its --dist-timeout (and a margin), leaving no process."""
    import asyncio
    import signal

    needle = f"--port\0{server.port}\0".encode()
    worker = None
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if needle in cmd and b"--dist-rank\x001\x00" in cmd:
            worker = int(pid)
    if worker is None:
        fail(f"14c: no rank 1 of {server.name}")

    async def traffic():
        jobs = [asyncio.ensure_future(ws_client(
                    server.port, f"k{i}", data, "2pass", PACE_S,
                    first=first))
                for i, ((data, _), first) in enumerate(zip(streams[:2],
                                                           firsts[:2]))]
        jobs.append(asyncio.ensure_future(p14_upload(
            server.port, "k_up", longs[0], vad_max_len=400000)))
        await asyncio.sleep(3.0)
        os.kill(worker, signal.SIGKILL)
        return await asyncio.gather(*jobs, return_exceptions=True)

    t0 = time.perf_counter()
    outcome = asyncio.run(traffic())
    try:
        rc = server.proc.wait(timeout=P14_DIST_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        fail(f"14c: {server.name} still running "
             f"{P14_DIST_TIMEOUT_S + 60} s after its worker died")
    took = time.perf_counter() - t0
    server.stop(timeout=5)
    if rc == 0 or server.left():
        fail(f"14c: {server.name} exited {rc} after its worker died, or "
             f"left a process:\n{server.tail()}")
    return {"exit_code": rc, "exit_s": took, "requests_failed": sum(
        isinstance(r, BaseException) for r in outcome)}


def phase14_alone(gen, card: str, t_start: float, one_card: bool) -> int:
    """`chip_smoke.py --phase 14`: the kernels' build, the dirs phase 14
    serves (phase 7's, 9a's and 9b's), then phase 14 alone (its
    multi-card part on every visible card); `--phase 14c`: the
    multi-card part alone."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        with CLOCK.part("build"):
            save_2pass_dirs(tmp, gen)
            save_hotword_dir(tmp, gen)
            save_svs_dir(tmp, gen)
        with CLOCK.phase("14"):
            _, p14 = phase14(tmp, card, one_card)
    print(f"phase 14: {json.dumps(p14)}")
    print(f"phase seconds: {json.dumps(CLOCK.rows)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def p14_control(tmp: str, d: dict, card: str) -> dict:
    """14x: the load control for 14a's paced connections. Four servers on
    one card, two at --tp-devices 1 and two at --tp-devices 0, each given
    the 150 s and 270 s uploads while its paced connections start
    together (not P14_STAGGER_S apart), so that the lane's batches follow
    the messages' timing. Gated: every stream (one final a burst) and
    every upload equal on the four; measured: how many connections agree,
    each server against its twin and tp 1 against tp 0, the first
    differing connection's results, and each server's tick and pass-2
    stage times and fan-out numbers."""
    import asyncio

    streams, firsts, _, longs = p14_requests()
    tp1 = p14_flags(d) + ["--tp-devices", "1"]
    servers = {"tp1": P14Server.server(tmp, "x_tp1", tp1),
               "tp1b": P14Server.server(tmp, "x_tp1b", tp1),
               "tp0": P14Server.server(tmp, "x_tp0", p14_flags(d)),
               "tp0b": P14Server.server(tmp, "x_tp0b", p14_flags(d))}

    async def drive(port):
        ups, clients = await asyncio.gather(
            p14_uploads(port, longs),
            p14_clients(port, streams, firsts, stagger=0.0))
        return clients, ups, await p14_stats(port)

    async def every():
        return await asyncio.gather(*[drive(s.port)
                                      for s in servers.values()])

    t0 = time.perf_counter()
    try:
        with CLOCK.part("build"):
            start = {k: s.wait_up() for k, s in servers.items()}
        res = dict(zip(servers, asyncio.run(every())))
    finally:
        rcs = {k: s.stop() for k, s in servers.items()}
    if any(rc != 0 for rc in rcs.values()) or any(
            s.left() for s in servers.values()):
        fail(f"14x: a server did not stop cleanly: {rcs}")
    for k, (clients, _, _) in res.items():
        for i, ((_, msgs), (_, spans)) in enumerate(zip(clients, streams)):
            p14_check_stream(k, f"c{i}", msgs, spans)
    ups = {k: [u[:2] for u in r[1]] for k, r in res.items()}
    if any(u != ups["tp0"] for u in ups.values()) or not all(
            u[0] for u in ups["tp0"]):
        fail(f"14x: the long uploads differ or are empty: {ups}")
    view = {k: [m for _, m in r[0]] for k, r in res.items()}
    n = {"card": card, "start_s": start, "traffic_s":
         time.perf_counter() - t0 - max(start.values())}
    for a, b in (("tp0b", "tp0"), ("tp1b", "tp1"), ("tp1", "tp0"),
                 ("tp1b", "tp0b")):
        n[f"{a}_vs_{b}"] = p14_agreement(view[a], view[b])
    stage = lambda st, k: [st["stages"][k]["p50_ms"], st["stages"][k]["p95_ms"],
                           st["stages"][k].get("count")] \
        if k in st["stages"] else None
    n["stages"] = {k: {s_: stage(r[2], s_) for s_ in ("tick",
                                                     "p2_recognize")}
                   for k, r in res.items()}
    n["fanout"] = {k: {f: r[2]["fanout"][f] for f in (
        "calls", "broadcasts_a_call", "lock_wait_ms")}
        for k, r in res.items() if "fanout" in r[2]}
    for i in range(len(streams)):
        a, b = (p14_stream_view(view[k][i]) for k in ("tp1", "tp0"))
        if a != b:
            n["first_differing"] = {"connection": i, "tp1": a, "tp0": b}
            break
    print(f"14x: {P14_CONNECTIONS} paced connections started together "
          f"beside the {', '.join(f'{s:.0f}' for s in P14_UPLOADS)} s "
          f"uploads on four servers: {json.dumps(n, ensure_ascii=False)}",
          flush=True)
    return n


def phase14_control(gen, card: str, t_start: float) -> int:
    """`chip_smoke.py --phase 14x`: the kernels' build, the dirs 14a
    serves (phase 7's, 9a's), then p14_control."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        with CLOCK.part("build"):
            save_2pass_dirs(tmp, gen)
            save_hotword_dir(tmp, gen)
        with CLOCK.phase("14x"):
            n = p14_control(tmp, p14_dirs(tmp), card)
    print(f"phase 14x: {json.dumps(n)}")
    print(f"phase seconds: {json.dumps(CLOCK.rows)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(REPO, PACKAGE)):
        print("chip_smoke: run from the root of a checkout (no "
              f"{PACKAGE})", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from asr2pass_tpu_torch.native import bindings as nb
    from asr2pass_tpu_torch.ops import attention as att

    # a crash in native code (the host library, the CUDA stack, the profiler)
    # prints the faulting thread's native frames and every thread's Python
    # stack before the process dies
    install_crash_trace()
    faulthandler.enable()
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    # the native host library builds with g++ beside the kernels' nvcc
    native_build = {}

    def build_native():
        t1 = time.perf_counter()
        try:
            native_build["lib"] = nb.build()
        except RuntimeError as e:
            native_build["error"] = e
        native_build["s"] = time.perf_counter() - t1

    builder = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    early = CLOCK.phase("1-2")
    early.__enter__()
    builder.start()
    lib = att.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s; ptxas: "
          f"{' | '.join(ptxas_usage(lib.with_suffix('.log').read_text()))}",
          flush=True)
    builder.join()
    if "error" in native_build:
        fail(f"the native library does not build: {native_build['error']}")
    native = {"card": card, "build_s": native_build["s"]}
    print(f"build: {native_build['lib'].name} (g++) in "
          f"{native_build['s']:.1f} s", flush=True)
    with CLOCK.part("cpu"):
        native["resample"] = resample_gate(card)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] in (["--phase", "13"], ["--phase", "13f"]):
        early.__exit__(None, None, None)
        return phase13_alone(gen, card, t_start, sys.argv[2] == "13")
    if sys.argv[1:] in (["--phase", "14"], ["--phase", "14c"]):
        early.__exit__(None, None, None)
        return phase14_alone(gen, card, t_start, sys.argv[2] == "14")
    if sys.argv[1:] == ["--phase", "14x"]:
        early.__exit__(None, None, None)
        return phase14_control(gen, card, t_start)
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (takes none, "
              "--phase 13, 13f, 14, 14c or 14x)", file=sys.stderr)
        return 2
    kernels, svs_kernels = kernel_phase(gen)
    early.__exit__(None, None, None)
    with tempfile.TemporaryDirectory() as tmp:
        with CLOCK.phase("3-6"):
            launches, speed = main_path(os.path.join(tmp, "model"), gen,
                                        card)
        with CLOCK.phase("7"):
            launches_2pass, two_pass = two_pass_phase(
                os.path.join(tmp, "model"), tmp, gen, card)
        with CLOCK.phase("8"):
            launches_engine, engine_fwd, server = server_phase(
                os.path.join(tmp, "model"), tmp, card)
        with CLOCK.phase("9"):
            launches_p9, p9 = phase9(tmp, gen, card)
        with CLOCK.phase("10"):
            launches_p10, p10 = phase10(tmp, card)
        with CLOCK.phase("11"):
            launches_p11, p11 = phase11(tmp, gen, card)
        with CLOCK.phase("12"):
            launches_p12, p12 = phase12(tmp, card)
        # phase 14's servers start while phase 13 runs
        fleet = p14_start(tmp)
        try:
            with CLOCK.phase("13"):
                launches_p13, p13 = phase13(tmp, gen, card)
        except BaseException:
            p14_stop(fleet)
            raise
        with CLOCK.phase("14"):
            launches_p14, p14 = phase14(tmp, card, fleet=fleet)
    # kernel #1 fp32 at the engine's pass-2 shape: the largest batch the
    # lane ran at bucket 256
    b_eng = max(b for b, t in engine_fwd if t == 256)
    engine_case = kernel_case("mh_flash_attention", (b_eng, 256, 256, 512, 4),
                              "float32", gen)
    print(f"kernel mh_flash_attention {engine_case['shape']} float32 (the "
          f"engine's pass 2): max_abs_err {engine_case['max_abs_err']:.3e} "
          f"({engine_case['tol_ratio']:.3f} of tolerance; dropped-key "
          f"control {engine_case['control_tol_ratio']:.1f}; TF32 control "
          f"{engine_case['tf32_control_tol_ratio']:.3f}), ms back to back / "
          f"device / host: kernel {engine_case['ms']:.4f} / "
          f"{engine_case['device_ms']:.4f} / {engine_case['host_ms']:.4f}, "
          f"plain {engine_case['plain_ms']:.4f} / "
          f"{engine_case['plain_device_ms']:.4f} / "
          f"{engine_case['plain_host_ms']:.4f}, sdpa "
          f"{engine_case['library_ms']:.4f} / "
          f"{engine_case['library_device_ms']:.4f} / "
          f"{engine_case['library_host_ms']:.4f}; bound "
          f"{engine_case['bound_ms']:.4f} by {engine_case['bound_by']}",
          flush=True)
    if not (engine_case["tol_ratio"] <= 1
            and engine_case["control_tol_ratio"] > 1
            and engine_case["tf32_control_tol_ratio"] > 1):
        fail("mh_flash_attention at the engine's pass-2 shape fails its "
             "checks")

    # one entry per CUDA kernel and entry point: the fp32 kernel
    # (attention_f32_sm90.cu) and the bf16 kernel (attention_sm90.cu), each
    # at the entry point's first main-path shape, its other shapes as
    # variants; launches are the offline main path's run in that dtype,
    # launches_2pass the 2pass session's, launches_engine the paced server
    # run's (8a), launches_<path> phase 9's (hotword: 9a's 16 x 15 s,
    # svs: 9b's 60/150/270 s, hotword_engine: 9c, svs_engine: 9d) and
    # phase 10's (lm_offline: 10a's 16 x 15 s with the native LM decoder,
    # lm_svs: 10b's 16 x 60 s with TLG items, lm_engine: 10c); #1
    # fp32 carries the engine's pass-2 shape as a variant, and the fp32
    # entries SenseVoice's shapes (T = bucket + 4)
    line = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "host_ms", "plain_device_ms",
            "plain_host_ms", "library_device_ms", "library_host_ms",
            "bound_simt_ms", "tf32_control_tol_ratio",
            "tf32_rna_control_tol_ratio", "schedule", "steps_ms")
    for dt, (_, source) in att.KERNELS.items():
        dtype = str(dt).removeprefix("torch.")
        source = f"asr2pass_tpu_torch/{source}"
        for name, runs in kernels.items():
            runs = [r for r in runs if r["dtype"] == dtype]
            head = runs[0]
            variants = [{k: r[k] for k in ("shape", "tol_ratio") + keys}
                        for r in runs[1:]]
            if (name, dtype) == ("mh_flash_attention", "float32"):
                variants.append({
                    "path": "engine pass 2",
                    "launches_engine": launches_engine[name][dtype],
                    **{k: engine_case[k] for k in ("shape", "tol_ratio")
                       + keys}})
            variants += [{"path": r["path"],
                          **{k: r[k] for k in ("shape", "tol_ratio") + keys}}
                         for r in svs_kernels + p13["13e"]
                         if r["name"] == name and r["dtype"] == dtype]
            line.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": REPLACES[name],
                "launches": launches[dtype][name],
                "launches_2pass": launches_2pass[name][dtype],
                "launches_engine": launches_engine[name][dtype],
                **{f"launches_{path}": by[name][dtype]
                   for path, by in {**launches_p9, **launches_p10,
                                    **launches_p11, **launches_p12,
                                    **launches_p13, **launches_p14}.items()},
                **{k: head[k] for k in keys},
                "shape": head["shape"], "dtype": dtype,
                "tol_ratio": head["tol_ratio"],
                "control_tol_ratio": head["control_tol_ratio"],
                "variants": variants,
            })
    # the native host library: its gates' numbers, and the automaton's
    # stage times and native calls in the server runs
    native["automaton"] = two_pass["automaton"]
    native["vd_automaton_ms_p50_p95_count"] = {
        "8a": server["stages_8a"].get("vd_automaton"),
        "8b": server["stages_8b"].get("vd_automaton"),
        "9c": p9["9c"]["stages"].get("vd_automaton"),
        "9d": p9["9d"]["stages"].get("vd_automaton")}
    native["calls"] = {"8a": server["native_calls_8a"],
                       "9c": p9["9c"]["native_calls"],
                       "9d": p9["9d"]["native_calls"]}
    native["beam"] = p9["9b"]["beam"]
    native["9d_ms"] = {k: p9["9d"][k] for k in PYTHON_BEAM_9D_MS}
    native["9d_ms_python_beam"] = PYTHON_BEAM_9D_MS
    # phase 10: the LM decoder against LmDecoder, the TLG search a frame,
    # FstITN a final, the rows copied, and the LM engine run's native calls
    native["lm"] = {
        "lm_decode": p10["10a"]["decode"],
        "tlg_ms_per_frame": p10["10b"]["tlg_ms_per_frame"],
        "tlg_frames": p10["10b"]["tlg_frames"],
        "itn_ms_per_final": p10["10c"]["itn_ms_per_final"],
        "itn_chars_per_final": p10["10c"]["itn_chars_per_final"],
        "lm_bytes_copied": {"10a_native": p10["10a"]["lm_bytes_native"],
                            "10a_tlg": p10["10a"]["lm_bytes_tlg"],
                            "10b": p10["10b"]["lm_bytes"],
                            "10b_logits": p10["10b"]["logits_bytes"]},
        "graphs": p10["lm"]}
    native["calls"]["10c"] = p10["10c"]["native_calls"]
    print(f"speed: {json.dumps(speed)}")
    print(f"phase 9: {json.dumps(p9)}")
    print(f"phase 10: {json.dumps(p10)}")
    print(f"phase 11: {json.dumps(p11)}")
    print(f"phase 12: {json.dumps(p12)}")
    print(f"phase 13: {json.dumps(p13_numbers(p13))}")
    print(f"phase 14: {json.dumps(p14)}")
    print(f"phase seconds: {json.dumps(CLOCK.rows)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"native": native}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
