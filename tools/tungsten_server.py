#!/usr/bin/env python
"""HTTP render server — the analog of src/tungsten-server (civetweb):
/status (JSON spp/queue state), /render (PNG of the live framebuffer),
/log (recent log lines). Renders in a worker thread while serving."""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

STATE = {
    "state": "idle",
    "scene": "",
    "currentSpp": 0,
    "totalSpp": 0,
    "queue": [],
    "log": [],
    "frame": None,  # (H, W, 3) float linear
    "tonemap": "gamma",
    "lock": threading.Lock(),
}


def log(msg):
    line = f"[{time.strftime('%H:%M:%S')}] {msg}"
    with STATE["lock"]:
        STATE["log"].append(line)
        STATE["log"] = STATE["log"][-200:]
    print(line, flush=True)


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/status"):
            with STATE["lock"]:
                body = json.dumps(
                    {
                        "state": STATE["state"],
                        "scene": STATE["scene"],
                        "currentSpp": STATE["currentSpp"],
                        "totalSpp": STATE["totalSpp"],
                        "queue": STATE["queue"],
                    }
                ).encode()
            self._send(200, "application/json", body)
        elif self.path.startswith("/render"):
            import numpy as np
            import jax.numpy as jnp
            from tungsten_tpu.io.imageio import encode_png
            from tungsten_tpu.models.cameras import tonemap

            with STATE["lock"]:
                frame = STATE["frame"]
                tm = STATE["tonemap"]
            if frame is None:
                self._send(404, "text/plain", b"no frame yet")
                return
            ldr = np.clip(np.asarray(tonemap(tm, jnp.asarray(frame))), 0, 1)
            u8 = np.clip((ldr * 255).astype(np.int32), 0, 255).astype(np.uint8)
            self._send(200, "image/png", encode_png(u8))
        elif self.path.startswith("/log"):
            with STATE["lock"]:
                body = "\n".join(STATE["log"]).encode()
            self._send(200, "text/plain", body)
        else:
            self._send(404, "text/plain", b"endpoints: /status /render /log")


def render_worker(scenes, spp_override, seed):
    from tungsten_tpu.renderer.render import render_buffers
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    for path in scenes:
        try:
            log(f"loading {path}")
            doc = load_scene(path)
            scene = flatten_scene(doc)
            spp = spp_override or scene.meta.spp
            with STATE["lock"]:
                STATE.update(state="rendering", scene=path, totalSpp=spp, currentSpp=0,
                             tonemap=scene.meta.tonemap)
            def on_ckpt(bufs, done_passes):
                with STATE["lock"]:
                    STATE["frame"] = bufs.color()
                    STATE["currentSpp"] = int(bufs.count.min())
                log(f"{path}: {int(bufs.count.min())}/{spp} spp")

            bufs = render_buffers(
                scene, spp=spp, seed=seed,
                checkpoint_cb=on_ckpt, checkpoint_interval=2.0,
            )
            with STATE["lock"]:
                STATE["frame"] = bufs.color()
                STATE["currentSpp"] = spp
            log(f"finished {path}")
        except Exception as e:
            log(f"FAILED {path}: {e}")
    with STATE["lock"]:
        STATE["state"] = "idle"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--seed", type=int, default=0xBA5EBA11)
    args = ap.parse_args()

    from tungsten_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    STATE["queue"] = list(args.scenes)
    t = threading.Thread(target=render_worker, args=(args.scenes, args.spp, args.seed), daemon=True)
    t.start()
    log(f"serving on :{args.port}")
    ThreadingHTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()
