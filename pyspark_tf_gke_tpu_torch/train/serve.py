"""HTTP serving of an exported bundle on the card (the subset of
``pyspark_tf_gke_tpu/train/serve.py`` this slice carries).

``python -m pyspark_tf_gke_tpu_torch.train.serve --bundle DIR
--continuous-slots 8`` loads a bundle onto ``--device`` (``cuda`` by
default) and answers

* ``GET  /healthz``      -> 200 with the bundle and engine status;
* ``POST /v1/generate``  -> ``{"completions": [{"prompt", "completion",
  "new_tokens", "latency_ms"}, ...]}`` for ``{"prompts": [...]}`` (or
  ``"prompt"``), ``max_new_tokens``, ``temperature``, ``top_k``,
  ``top_p``, ``repetition_penalty``, ``seed``;
* ``POST /v1/score``     -> ``{"scores": [{"nll", "tokens",
  "truncated"}, ...]}`` for ``{"texts": [...]}``.

Routing follows the JAX server: with ``--continuous-slots`` greedy and
temperature/top-p requests share the slot engine's KV slots; top-k and
repetition-penalty requests run the whole-batch ``generate``. Beam
search, streaming, ``/loadz``, tenants, deadlines, drain and reload are
not ported yet and answer 400 where a request asks for them (ROADMAP
queue 1, P7).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer
from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.causal_lm import generate
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle
from pyspark_tf_gke_tpu_torch.train.serving import serve_score
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("torch.train.serve")

MAX_BODY_BYTES = 8 << 20
MAX_BATCH = 64


class NotPorted(ValueError):
    """A request feature the port does not serve yet (HTTP 400)."""


class _ContinuousFront:
    """One engine thread runs the slot engine; HTTP threads ``submit``
    (non-blocking) and ``wait`` for their tokens. A step that raises
    fails every outstanding request with the error and the engine is
    rebuilt (its device state may be mid-chunk garbage)."""

    def __init__(self, make_engine):
        self._make_engine = make_engine
        self.engine: ContinuousEngine = make_engine()
        self.lock = threading.Lock()  # guards the engine
        self._results_lock = threading.Lock()
        self._results: Dict[int, list] = {}  # rid -> [event, result]
        self.new_work = threading.Event()
        self._stop = False
        self.thread = threading.Thread(target=self._loop,
                                       name="continuous-engine", daemon=True)
        self.thread.start()

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, top_p=None, seed: int = 0) -> int:
        with self.lock:
            rid = self.engine.submit(prompt_ids, max_new_tokens,
                                     temperature=temperature, top_p=top_p,
                                     seed=seed)
            with self._results_lock:
                self._results[rid] = [threading.Event(), None]
        self.new_work.set()
        return rid

    def wait(self, rid: int, timeout_s: float = 600.0) -> List[int]:
        with self._results_lock:
            entry = self._results.get(rid)
        if entry is None:
            raise KeyError(f"unknown or already-collected request {rid}")
        if not entry[0].wait(timeout_s):
            self.abandon(rid)
            raise RuntimeError(
                f"continuous decode timed out after {timeout_s}s")
        with self._results_lock:
            self._results.pop(rid, None)
        if isinstance(entry[1], Exception):
            raise RuntimeError(
                f"continuous engine failed this request: {entry[1]}")
        return entry[1]

    def abandon(self, rid: int) -> None:
        """Cancel a request nobody will collect (frees its KV slot)."""
        with self.lock:
            self.engine.cancel(rid)
        with self._results_lock:
            self._results.pop(rid, None)

    def _deliver(self, rid: int, result) -> None:
        with self._results_lock:
            entry = self._results.get(rid)
        if entry is not None:
            entry[1] = result
            entry[0].set()

    def _loop(self) -> None:
        while not self._stop:
            if not self.new_work.wait(timeout=0.5):
                continue
            with self.lock:
                if not self.engine.busy:
                    self.new_work.clear()
                    continue
                try:
                    finished = self.engine.step()
                except Exception as exc:  # noqa: BLE001 — keep serving
                    logger.exception("engine step failed; rebuilding")
                    failed = self.engine.outstanding_requests()
                    self.engine = self._make_engine()
                    finished = []
                    for req in failed:
                        self._deliver(req.rid, exc)
            for req in finished:
                self._deliver(req.rid, list(req.tokens))

    def stats(self) -> dict:
        with self.lock:
            return self.engine.stats

    def shutdown(self, timeout_s: float = 10.0) -> None:
        self._stop = True
        self.new_work.set()
        self.thread.join(timeout_s)


class BundleServer:
    """Loads a bundle onto ``device`` and serves generate/score. With
    ``continuous_slots > 0`` a slot engine (``--continuous-slots``,
    ``--continuous-chunk``) serves greedy and temperature/top-p
    requests; ``prefill_chunk`` and ``step_token_budget`` are its
    chunked prefill (``--prefill-chunk``, ``--step-token-budget``)."""

    def __init__(self, bundle_dir: str, device: str = "cuda",
                 continuous_slots: int = 0, continuous_chunk: int = 8,
                 int8_kv: bool = False, prefill_chunk: int = 0,
                 step_token_budget: int = 0):
        if prefill_chunk and not continuous_slots:
            raise ValueError(
                "--prefill-chunk requires --continuous-slots (chunked "
                "prefill is a slot-engine feature)")
        self.device = resolve_device(device)
        model, _, meta = load_serving_bundle(bundle_dir, self.device)
        if int8_kv and not model.cfg.kv_cache_quant:
            # the cache layout is a serving-time choice (weights unchanged)
            cfg = dataclasses.replace(model.cfg, kv_cache_quant=True)
            for module in model.modules():
                if hasattr(module, "cfg"):
                    module.cfg = cfg
        self.bundle_dir, self.model, self.meta = bundle_dir, model, meta
        self.tokenizer = get_tokenizer(meta.get("tokenizer", "byte"))
        if self.tokenizer.vocab_size > model.cfg.vocab_size:
            raise ValueError(
                f"bundle tokenizer vocab {self.tokenizer.vocab_size} exceeds "
                f"model vocab {model.cfg.vocab_size}")
        self._lock = threading.Lock()  # whole-batch generate and score
        self._front: Optional[_ContinuousFront] = None
        if continuous_slots > 0:
            eos_id = getattr(self.tokenizer, "eos_id", None)
            pad_id = getattr(self.tokenizer, "pad_id", 0)
            self._front = _ContinuousFront(lambda: ContinuousEngine(
                model, num_slots=continuous_slots, chunk=continuous_chunk,
                eos_token_id=eos_id, pad_id=pad_id,
                prefill_chunk=prefill_chunk,
                step_token_budget=step_token_budget))

    def health(self) -> dict:
        return {
            "status": "ok",
            "bundle": self.bundle_dir,
            "format": self.meta.get("format"),
            "model": self.meta.get("model"),
            "quantized": bool(self.meta.get("quantized")),
            "vocab_size": self.model.cfg.vocab_size,
            "max_seq_len": self.model.cfg.max_seq_len,
            "tokenizer": self.meta.get("tokenizer", "byte"),
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "continuous": (self._front.stats()
                           if self._front is not None else None),
        }

    def _entry(self, prompt: str, new_tokens: List[int], dt_ms: float,
               eos_id) -> dict:
        if eos_id is not None and eos_id in new_tokens:
            new_tokens = new_tokens[:new_tokens.index(eos_id)]
        return {
            "prompt": prompt,
            "completion": prompt + self.tokenizer.decode(new_tokens),
            "new_tokens": len(new_tokens),
            "latency_ms": round(dt_ms, 2),
        }

    def generate(self, prompts, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 num_beams: int = 0, repetition_penalty=None,
                 seed=None) -> list:
        """Batch completion, results in input order. Slot-engine
        requests draw their sampling lane from ``seed + index`` when the
        client pins ``seed`` (deterministic per prompt and seed)."""
        if num_beams and num_beams > 1:
            raise NotPorted("num_beams (beam search) is not yet ported")
        if not prompts:
            return []
        if len(prompts) > MAX_BATCH:
            raise ValueError(f"batch of {len(prompts)} exceeds max batch "
                             f"{MAX_BATCH}")
        cfg = self.model.cfg
        eos_id = getattr(self.tokenizer, "eos_id", None)
        encoded = []
        for i, text in enumerate(prompts):
            ids = self.tokenizer.encode(text)
            if not ids:
                raise ValueError(f"prompt {i} tokenized to zero tokens")
            if len(ids) + max_new_tokens > cfg.max_seq_len:
                raise ValueError(
                    f"prompt {i}: {len(ids)} tokens + {max_new_tokens} new "
                    f"exceeds max_seq_len {cfg.max_seq_len}")
            encoded.append((i, ids))
        engine_ok = (not num_beams and repetition_penalty is None
                     and top_k is None)
        if self._front is not None and engine_ok:
            t0 = time.perf_counter()
            temp = float(temperature or 0.0)
            rids = []
            try:
                for i, ids in encoded:
                    rids.append((i, self._front.submit(
                        ids, max_new_tokens, temperature=temp, top_p=top_p,
                        seed=(int(seed) + i if seed is not None else
                              int.from_bytes(os.urandom(4), "little")))))
            except Exception:
                for _, rid in rids:
                    self._front.abandon(rid)
                raise
            toks = {}
            try:
                for i, rid in rids:
                    toks[i] = self._front.wait(rid)
            except Exception:
                for i, rid in rids:
                    if i not in toks:
                        self._front.abandon(rid)
                raise
            dt = (time.perf_counter() - t0) * 1000.0
            return [self._entry(prompts[i], toks[i], dt, eos_id)
                    for i, _ in rids]

        groups: Dict[int, list] = {}
        for i, ids in encoded:
            groups.setdefault(len(ids), []).append((i, ids))
        results = [None] * len(prompts)
        sampling = bool(temperature and temperature > 0)
        with self._lock:
            for length, members in sorted(groups.items()):
                rows = [ids for _, ids in members]
                gen = None
                if sampling:
                    gen = torch.Generator(device=self.device).manual_seed(
                        int(seed) % (1 << 64) if seed is not None else
                        int.from_bytes(os.urandom(4), "little"))
                t0 = time.perf_counter()
                out = generate(self.model, np.asarray(rows, np.int64),
                               max_new_tokens=max_new_tokens,
                               temperature=float(temperature or 0.0),
                               generator=gen, eos_token_id=eos_id,
                               top_k=top_k, top_p=top_p,
                               repetition_penalty=repetition_penalty)
                toks = out[:, length:].cpu().numpy()
                dt = (time.perf_counter() - t0) * 1000.0
                for row, (i, _) in enumerate(members):
                    results[i] = self._entry(prompts[i], toks[row].tolist(),
                                             dt, eos_id)
        return results

    def score(self, texts) -> list:
        """Per-text total NLL in nats and the scored token count. Texts
        longer than max_seq_len are truncated (``truncated``); texts
        under 2 tokens come back ``{"skipped": true, "tokens": 0}``."""
        if not texts:
            return []
        if len(texts) > MAX_BATCH:
            raise ValueError(f"batch of {len(texts)} exceeds max batch "
                             f"{MAX_BATCH}")
        cap = self.model.cfg.max_seq_len
        results: list = [None] * len(texts)
        rows = []
        for i, text in enumerate(texts):
            ids = self.tokenizer.encode(text)
            if len(ids) < 2:
                results[i] = {"nll": 0.0, "tokens": 0, "truncated": False,
                              "skipped": True}
                continue
            rows.append((i, ids[:cap], len(ids) > cap))
        if rows:
            # right padding to the longest text: causal attention keeps
            # every real position blind to the padding after it
            lengths = [len(ids) for _, ids, _ in rows]
            padded = np.zeros((len(rows), max(lengths)), np.int64)
            for r, (_, ids, _) in enumerate(rows):
                padded[r, :len(ids)] = ids
            with self._lock:
                nlls = serve_score(self.model, padded, lengths)
            for r, (i, ids, trunc) in enumerate(rows):
                results[i] = {"nll": float(nlls[r]), "tokens": len(ids) - 1,
                              "truncated": trunc}
        return results

    def shutdown(self) -> None:
        if self._front is not None:
            self._front.shutdown()


def _make_handler(server: BundleServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet per-request logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.partition("?")[0] in ("/healthz", "/health", "/"):
                return self._reply(200, server.health())
            self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                return self._reply(400, {"error": "bad Content-Length"})
            if length > MAX_BODY_BYTES:
                self.close_connection = True
                return self._reply(413, {"error": "request body too large"})
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                if self.path == "/v1/generate":
                    prompts = req.get("prompts")
                    if prompts is None and "prompt" in req:
                        prompts = [req["prompt"]]
                    if not isinstance(prompts, list) or not all(
                            isinstance(p, str) for p in prompts or [None]):
                        return self._reply(
                            400, {"error": "'prompts' must be a list of "
                                           "strings (or 'prompt': str)"})
                    if req.get("stream"):
                        raise NotPorted("stream (SSE) is not yet ported")
                    seed = req.get("seed")
                    out = server.generate(
                        prompts,
                        max_new_tokens=int(req.get("max_new_tokens", 64)),
                        temperature=float(req.get("temperature", 0.0)),
                        top_k=req.get("top_k"), top_p=req.get("top_p"),
                        num_beams=int(req.get("num_beams", 0)),
                        repetition_penalty=req.get("repetition_penalty"),
                        seed=int(seed) if seed is not None else None)
                    self._reply(200, {"completions": out})
                elif self.path == "/v1/score":
                    texts = req.get("texts")
                    if not isinstance(texts, list) or not all(
                            isinstance(t, str) for t in texts or [None]):
                        return self._reply(
                            400, {"error": "'texts' must be a list of "
                                           "strings"})
                    self._reply(200, {"scores": server.score(texts)})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (TypeError, ValueError) as exc:
                # caller error (NotPorted included), not a server fault
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — keep the server up
                logger.exception("request failed")
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def start_http_server(server: BundleServer, host: str = "0.0.0.0",
                      port: int = 8000) -> ThreadingHTTPServer:
    """Bind and return the HTTP server (``port=0`` -> ephemeral; read it
    from ``.server_address[1]``). The caller runs ``serve_forever``."""
    return ThreadingHTTPServer((host, port), _make_handler(server))


def parse_args(argv=None) -> argparse.Namespace:
    e = os.environ.get
    p = argparse.ArgumentParser(
        description="Serve an exported bundle over HTTP on the card")
    p.add_argument("--bundle", default=e("BUNDLE_DIR"),
                   required=e("BUNDLE_DIR") is None,
                   help="directory written by train/export.py")
    p.add_argument("--host", default=e("SERVE_HOST", "0.0.0.0"))
    p.add_argument("--port", type=int, default=int(e("SERVE_PORT", "8000")))
    p.add_argument("--continuous-slots", type=int,
                   default=int(e("CONTINUOUS_SLOTS", "0")),
                   help="KV slots of the continuous-batching engine (0 = "
                        "whole-batch serving); needs a paged bundle")
    p.add_argument("--continuous-chunk", type=int,
                   default=int(e("CONTINUOUS_CHUNK", "8")),
                   help="decode steps per engine chunk between admissions")
    p.add_argument("--prefill-chunk", "--prefill-chunk-tokens",
                   dest="prefill_chunk", type=int,
                   default=int(e("PREFILL_CHUNK", "0")),
                   help="chunked prefill: admit prompts longer than this "
                        "in pieces of this many tokens, written straight "
                        "into the page pool, with decode chunks "
                        "interleaved (0 = whole-prompt prefill; 0 or >= "
                        "32; requires --continuous-slots)")
    p.add_argument("--step-token-budget", type=int,
                   default=int(e("STEP_TOKEN_BUDGET", "0")),
                   help="cap the tokens one engine step dispatches, split "
                        "between the prefill piece and the decode chunk "
                        "(live slots x steps): bounds the time between "
                        "tokens under long-prompt arrivals (0 = off; pair "
                        "with --prefill-chunk)")
    p.add_argument("--int8-kv", action="store_true",
                   default=e("SERVE_INT8_KV", "") == "1",
                   help="serve with an int8 KV cache")
    p.add_argument("--device", default=e("SERVE_DEVICE", "cuda"),
                   help="torch device ('cuda' or 'cpu')")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    server = BundleServer(args.bundle, device=args.device,
                          continuous_slots=args.continuous_slots,
                          continuous_chunk=args.continuous_chunk,
                          int8_kv=args.int8_kv,
                          prefill_chunk=args.prefill_chunk,
                          step_token_budget=args.step_token_budget)
    httpd = start_http_server(server, args.host, args.port)
    logger.info("serving on http://%s:%d (healthz, /v1/generate, /v1/score)",
                *httpd.server_address[:2])
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda signum, frame: threading.Thread(
            target=httpd.shutdown, daemon=True).start())
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        httpd.server_close()
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
