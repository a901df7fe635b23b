"""Serving-bundle evaluation: perplexity and sample generations (the
counterpart of ``pyspark_tf_gke_tpu/evaluate/lm_eval.py``).

* held-out **perplexity** over a text glob, through the tokenizer the
  bundle records and the training eos-packing (``data/text.py``): a full
  causal forward a batch, int8 weights dequantized into transients (the
  non-decode ``Dense`` path), the NLLs summed as device scalars with one
  host sync at the end;
* **sample generations** from prompts with the port's ``generate``, or
  ``beam_search`` when ``--num-beams > 1``;
* ``--endpoint URL`` evaluates a running ``train/serve.py`` over the
  wire instead: perplexity from ``/v1/score`` over whole documents,
  samples from ``/v1/generate``.

Usage::

    python -m pyspark_tf_gke_tpu_torch.evaluate.lm_eval \\
        --bundle ./lm-serve --data-pattern 'heldout/*.txt' \\
        --prompt "the tpu" --max-new-tokens 64 [--device cpu]

Prints one JSON line (perplexity, token count, samples), as the JAX
module does. It runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu_torch.data.text import (get_tokenizer,
                                                iter_documents, lm_batches)
from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
from pyspark_tf_gke_tpu_torch.models.causal_lm import generate
from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("evaluate.lm_eval")


def parse_args(argv=None) -> argparse.Namespace:
    e = os.environ.get
    p = argparse.ArgumentParser(
        description="Evaluate an exported causal-LM serving bundle")
    p.add_argument("--bundle",
                   help="directory written by train/export.py")
    p.add_argument("--endpoint", default=e("SERVE_ENDPOINT", ""),
                   help="URL of a running train/serve.py deployment "
                        "(e.g. http://serve:8000) — evaluates over the "
                        "wire instead of loading the bundle locally")
    p.add_argument("--data-pattern", default=e("DATA_PATTERN", ""),
                   help="glob of held-out text files for perplexity")
    p.add_argument("--batches", type=int, default=int(e("EVAL_BATCHES", "16")))
    p.add_argument("--batch-size", type=int, default=int(e("BATCH_SIZE", "8")))
    p.add_argument("--seq-len", type=int, default=int(e("SEQ_LEN", "0")),
                   help="0 = the bundle's max_seq_len")
    p.add_argument("--prompt", action="append", default=[],
                   help="prompt text for a sample generation (repeatable)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--num-beams", type=int, default=1,
                   help=">1 decodes samples with beam search instead of "
                        "greedy/sampling")
    p.add_argument("--repetition-penalty", type=float, default=None,
                   help=">1 discourages repeating seen tokens "
                        "(greedy/sampling path only)")
    p.add_argument("--device", default=e("DEVICE", "cuda"),
                   help="'cuda' (the default: kernels on the card) or 'cpu' "
                        "(the kernels' plain versions)")
    return p.parse_args(argv)


@torch.inference_mode()
def bundle_perplexity(model, tokenizer, pattern: str, seq_len: int,
                      batch_size: int, max_batches: int) -> dict:
    """Mean next-token cross-entropy over a deterministic pass of the
    pattern (eos-packed rows, unshuffled), exponentiated."""
    device = model.device
    nll = torch.zeros((), dtype=torch.float32, device=device)
    total_tok = 0
    rows = itertools.islice(
        lm_batches(pattern, tokenizer, seq_len, batch_size, repeat=False,
                   shuffle_buffer=1),
        max_batches)
    for batch in rows:
        ids = torch.from_numpy(batch["input_ids"]).to(device, torch.long)
        logits = model(ids)[:, :-1].float()
        nll += F.cross_entropy(logits.transpose(1, 2), ids[:, 1:],
                               reduction="sum")
        total_tok += ids.shape[0] * (ids.shape[1] - 1)  # host-known
    if total_tok == 0:
        raise ValueError(f"no evaluation rows from {pattern!r}")
    mean_nll = float(nll) / total_tok
    return {
        "perplexity": float(np.exp(min(mean_nll, 30.0))),
        "mean_nll": mean_nll,
        "tokens": total_tok,
    }


def endpoint_eval(args) -> dict:
    """Remote evaluation against a running ``train/serve.py``: perplexity
    from ``/v1/score`` over whole documents (the server tokenizes and
    truncates at its max_seq_len, so it agrees with bundle mode in
    trend, not digit for digit), samples from ``/v1/generate``."""
    import urllib.request

    def post(path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            args.endpoint.rstrip("/") + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    result = {"endpoint": args.endpoint}
    if args.data_pattern:
        total_nll, total_tok = 0.0, 0

        def flush(batch):
            nonlocal total_nll, total_tok
            for s in post("/v1/score", {"texts": batch})["scores"]:
                total_nll += s["nll"]
                total_tok += s["tokens"]

        batch: list = []
        n_batches = 0
        for doc in iter_documents(args.data_pattern):
            batch.append(doc)
            if len(batch) == args.batch_size:
                flush(batch)
                batch = []
                n_batches += 1
                if n_batches >= args.batches:
                    break
        if batch and n_batches < args.batches:
            flush(batch)
        if total_tok == 0:
            raise ValueError(f"no scoreable documents from "
                             f"{args.data_pattern!r}")
        mean_nll = total_nll / total_tok
        result.update({"perplexity": float(np.exp(min(mean_nll, 30.0))),
                       "mean_nll": mean_nll, "tokens": total_tok})
    if args.prompt:
        out = post("/v1/generate", {
            "prompts": args.prompt,
            "max_new_tokens": args.max_new_tokens,
            "temperature": args.temperature,
            "top_p": args.top_p,
            "num_beams": args.num_beams if args.num_beams > 1 else 0,
            "repetition_penalty": args.repetition_penalty,
        })["completions"]
        result["samples"] = out
        for s in out:
            logger.info("sample: %r -> %r", s["prompt"], s["completion"])
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    args = parse_args(argv)
    if bool(args.bundle) == bool(args.endpoint):
        raise SystemExit("exactly one of --bundle or --endpoint is required")
    if args.endpoint:
        return endpoint_eval(args)
    model, _, meta = load_serving_bundle(args.bundle, device=args.device)
    tokenizer = get_tokenizer(meta.get("tokenizer", "byte"))
    if tokenizer.vocab_size > model.cfg.vocab_size:
        raise ValueError(
            f"bundle records tokenizer {meta.get('tokenizer')!r} with vocab "
            f"{tokenizer.vocab_size}, larger than the model's "
            f"{model.cfg.vocab_size} — token ids would index out of range")
    seq_len = args.seq_len or model.cfg.max_seq_len
    if seq_len > model.cfg.max_seq_len:
        raise ValueError(
            f"--seq-len {seq_len} exceeds the bundle's max_seq_len "
            f"{model.cfg.max_seq_len}: positions past it would clamp to "
            "the last position embedding and the perplexity would be "
            "silently wrong")

    result = {"bundle": args.bundle, "quantized": meta.get("quantized"),
              "model": meta.get("model")}
    if args.data_pattern:
        result.update(bundle_perplexity(
            model, tokenizer, args.data_pattern, seq_len, args.batch_size,
            args.batches))

    samples = []
    eos_id = getattr(tokenizer, "eos_id", None)
    if args.num_beams > 1 and (args.temperature > 0 or args.top_p
                               or args.repetition_penalty):
        logger.warning("--temperature/--top-p/--repetition-penalty are "
                       "ignored with --num-beams > 1 (beam search is "
                       "deterministic and unpenalized)")
    for prompt in args.prompt:
        ids = np.asarray([tokenizer.encode(prompt)], np.int32)
        if args.num_beams > 1:
            out, score = beam_search(model, ids,
                                     max_new_tokens=args.max_new_tokens,
                                     num_beams=args.num_beams,
                                     eos_token_id=eos_id)
            entry = {"prompt": prompt, "beam_score": float(score[0])}
        else:
            out = generate(model, ids, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.top_p,
                           eos_token_id=eos_id,
                           repetition_penalty=args.repetition_penalty)
            entry = {"prompt": prompt}
        toks = out[0, ids.shape[1]:].tolist()
        if eos_id is not None and eos_id in toks:
            toks = toks[:toks.index(eos_id)]  # strip eos padding
        entry["completion"] = prompt + tokenizer.decode(toks)
        samples.append(entry)
        logger.info("sample: %r -> %r", prompt, entry["completion"])
    if samples:
        result["samples"] = samples

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
