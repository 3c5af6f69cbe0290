#!/usr/bin/env python3
"""One-step model provisioning: fetch -> convert -> verify.

Counterpart of the JAX package's tools/fetch_model.py, in the role of the
reference server's ModelScope download
(funasr-wss-server-2pass.cpp:195-502, which shells out to
`python -m funasr.download.runtime_sdk_download_tool` per model dir):
resolve a ModelScope model id (or local dir), download its files over
the ModelScope HTTP API when absent, run tools/convert_funasr.py into our
npz layout, and optionally execute the shipped model.onnx as the
conversion oracle (--verify, on --device: the card unless cpu).

Offline-friendly: if the source dir already exists locally the fetch step
is skipped; with no network access the command says exactly what to copy
where and exits nonzero instead of half-provisioning.

Presets mirror the reference launch scripts' model sets
(websocket/run_server_2pass_ssl.sh:24-33):

  python -m asr2pass_tpu_torch.tools.fetch_model --preset 2pass-zh \\
      --out models/
  python -m asr2pass_tpu_torch.tools.fetch_model damo/speech_paraformer-... \\
      --out models/offline --verify [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

from asr2pass_tpu_torch.tools.transcribe import add_device_arg

MODELSCOPE = "https://modelscope.cn/api/v1/models"

# the model sets the reference's launch scripts provision
# (run_server_2pass_ssl.sh:24-33; offline servers use the same dirs)
PRESETS = {
    "2pass-zh": {
        "offline": "damo/speech_paraformer-large-vad-punc_asr_nat-zh-cn-"
                   "16k-common-vocab8404-onnx",
        "online": "damo/speech_paraformer-large_asr_nat-zh-cn-16k-common-"
                  "vocab8404-online-onnx",
        "vad": "damo/speech_fsmn_vad_zh-cn-16k-common-onnx",
        "punc": "damo/punc_ct-transformer_zh-cn-common-vad_realtime-"
                "vocab272727-onnx",
    },
    "offline-zh": {
        "offline": "damo/speech_paraformer-large-vad-punc_asr_nat-zh-cn-"
                   "16k-common-vocab8404-onnx",
        "vad": "damo/speech_fsmn_vad_zh-cn-16k-common-onnx",
        "punc": "damo/punc_ct-transformer_zh-cn-common-vocab272727-onnx",
    },
}

# files worth fetching from a runtime model dir (com-define.h:52-88 layout)
WANTED = ("model.pt", "model.onnx", "model_quant.onnx", "config.yaml",
          "am.mvn", "tokens.json", "seg_dict", "model_eb.onnx",
          "TLG.fst", "lexicon.txt", "zh_itn_tagger.fst",
          "zh_itn_verbalizer.fst", "configuration.json")


def _http_json(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def list_model_files(model_id: str, revision: str = "master"):
    """ModelScope repo listing: GET /api/v1/models/{id}/repo/files."""
    url = (f"{MODELSCOPE}/{model_id}/repo/files?Revision={revision}"
           f"&Recursive=true")
    data = _http_json(url)
    files = data.get("Data", {}).get("Files", [])
    return [f["Path"] for f in files if f.get("Type") != "tree"]


def fetch(model_id: str, dest: str, revision: str = "master") -> bool:
    """Download a ModelScope model dir. Returns False (with a message) when
    the network is unreachable."""
    os.makedirs(dest, exist_ok=True)
    try:
        paths = list_model_files(model_id, revision)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        print(f"cannot reach ModelScope ({e}); place the model files "
              f"manually in {dest} (need: model.pt or model.onnx, "
              f"config.yaml, am.mvn, tokens.json)", file=sys.stderr)
        return False
    wanted = [p for p in paths
              if os.path.basename(p) in WANTED or p in WANTED]
    if not wanted:
        wanted = paths  # unknown layout: take everything
    for p in wanted:
        url = (f"{MODELSCOPE}/{model_id}/repo?Revision={revision}"
               f"&FilePath={urllib.request.quote(p)}")
        out = os.path.join(dest, os.path.basename(p))
        print(f"  fetching {p}")
        try:
            with urllib.request.urlopen(url, timeout=600) as r, \
                    open(out, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            print(f"download failed for {p}: {e}", file=sys.stderr)
            return False
    return True


def provision(src: str, out: str, kind: str = "auto",
              verify: bool = False, revision: str = "master",
              device: str = "cuda") -> int:
    """fetch (if needed) + convert + verify one model dir; --verify runs
    on `device`."""
    from asr2pass_tpu_torch.tools import convert_funasr

    local = src
    if not os.path.isdir(src):
        local = os.path.join(out + ".src", src.replace("/", "__"))
        if not (os.path.isdir(local)
                and any(os.path.exists(os.path.join(local, f))
                        for f in ("model.pt", "model.onnx"))):
            print(f"fetching {src} -> {local}")
            if not fetch(src, local, revision):
                return 1
    argv = [local, out, "--kind", kind, "--device", device]
    if verify:
        argv.append("--verify")
    return convert_funasr.main(argv)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", nargs="?",
                   help="ModelScope id (damo/...) or local FunASR dir")
    p.add_argument("--preset", choices=sorted(PRESETS),
                   help="provision a full serving model set")
    p.add_argument("--out", required=True,
                   help="output dir (preset mode: parent dir, one subdir "
                        "per role)")
    p.add_argument("--kind", default="auto",
                   help="model family for conversion (default: detect)")
    p.add_argument("--revision", default="master")
    p.add_argument("--verify", action="store_true",
                   help="execute the shipped model.onnx and assert the "
                        "converted model matches (convert_funasr --verify)")
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.verify:
        from asr2pass_tpu_torch.utils import resolve_device

        resolve_device(args.device)     # refuse before any download
    if args.preset:
        rc = 0
        for role, model_id in PRESETS[args.preset].items():
            print(f"== {role}: {model_id}")
            kind = {"offline": "asr", "online": "asr", "vad": "vad",
                    "punc": "punc"}.get(role, "auto")
            rc |= provision(model_id, os.path.join(args.out, role),
                            kind=kind, verify=args.verify,
                            revision=args.revision, device=args.device)
        return rc
    if not args.model:
        p.error("need a model id/dir or --preset")
    return provision(args.model, args.out, kind=args.kind,
                     verify=args.verify, revision=args.revision,
                     device=args.device)


if __name__ == "__main__":
    sys.exit(main())
