"""Process supervisor: launch and restart a fleet of servers.

    python -m asr2pass_tpu_torch.server.run_all_servers \\
        [--config deploy/servers.yaml]

Counterpart of scripts/run_all_servers.py (the role of supervisord,
supervisord.conf:11-45: three servers under autorestart=true,
startretries=3). It reads the same layout, a `servers:` list of entries
and a `restart:` block, starts one `python -m
asr2pass_tpu_torch.server.run_server` per entry (build_cmd maps each key
the JAX supervisor maps), restarts a child that exits, at most
`startretries` times per entry when `autorestart` is on, and passes
SIGTERM and SIGINT on to every child.

Cards: `device: K` runs the entry on card K alone (CUDA_VISIBLE_DEVICES=K,
--device cuda); `device: "0,1"` gives an entry two cards, for
`tp_devices: 2` or `sp_devices: 2` (or both, the smaller dividing the
larger), whose child starts its own worker ranks (run_server's
launcher); `cpu: true` serves on the CPU (--device
cpu). When a worker rank dies, its rank 0 exits, and the entry restarts
as a whole.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

import yaml

POLL_S = 2.0             # seconds between checks of the children
# entry key -> the launcher's flag: keys with a value, then switches
_VALUE_FLAGS = {"model_dir": "--model-dir",
                "online_model_dir": "--online-model-dir",
                "vad_dir": "--vad-dir", "punc_dir": "--punc-dir",
                "decode_workers": "--decode-workers",
                "engine_capacity": "--engine-capacity",
                "svs_dir": "--svs-dir", "svs_beam": "--svs-beam",
                "lm_dir": "--lm-dir", "hotword_file": "--hotword-file",
                "itn_dir": "--itn-dir", "tp_devices": "--tp-devices",
                "sp_devices": "--sp-devices"}
_SWITCHES = {"demo": "--demo", "itn": "--itn", "engine": "--engine",
             "upload_overlap": "--upload-overlap",
             "decide_async": "--decide-async"}


def build_cmd(entry: dict):
    """(argv, env) of one entry's child."""
    cmd = [sys.executable, "-m", "asr2pass_tpu_torch.server.run_server",
           "--port", str(entry["port"])]
    cmd += [flag for key, flag in _SWITCHES.items() if entry.get(key)]
    for key, flag in _VALUE_FLAGS.items():
        if entry.get(key):
            cmd += [flag, str(entry[key])]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    if "device" in entry:
        dev = entry["device"]
        env["CUDA_VISIBLE_DEVICES"] = (",".join(str(d) for d in dev)
                                       if isinstance(dev, list)
                                       else str(dev))
    if entry.get("cpu"):
        cmd += ["--device", "cpu"]
    elif "device" in entry:
        cmd += ["--device", "cuda"]
    return cmd, env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m asr2pass_tpu_torch.server.run_all_servers")
    p.add_argument("--config", default="deploy/servers.yaml")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    restart = cfg.get("restart") or {}
    retries_max = restart.get("startretries", 3)
    autorestart = restart.get("autorestart", True)
    procs, retries = {}, {}
    running = True

    def shutdown(signum, frame):
        nonlocal running
        running = False
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    for entry in cfg["servers"]:
        cmd, env = build_cmd(entry)
        procs[entry["name"]] = subprocess.Popen(cmd, env=env)
        retries[entry["name"]] = 0
        print(f"started {entry['name']} on port {entry['port']} "
              f"(pid {procs[entry['name']].pid})", flush=True)

    while running:
        time.sleep(POLL_S)
        for entry in cfg["servers"]:
            name = entry["name"]
            proc = procs[name]
            if proc.poll() is not None and running:
                if not autorestart or retries[name] >= retries_max:
                    if retries[name] >= 0:
                        print(f"{name} exited rc={proc.returncode}; "
                              "giving up", flush=True)
                        retries[name] = -1
                    continue
                retries[name] += 1
                print(f"{name} exited rc={proc.returncode}; restart "
                      f"{retries[name]}/{retries_max}", flush=True)
                cmd, env = build_cmd(entry)
                procs[name] = subprocess.Popen(cmd, env=env)
                print(f"started {name} on port {entry['port']} "
                      f"(pid {procs[name].pid})", flush=True)
    for proc in procs.values():
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
