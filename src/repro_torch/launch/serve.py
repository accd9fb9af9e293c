"""Serving entry point: Pareto-front (skyline) request admission, then
batched prefill and greedy decode of a language model.

Counterpart of ``repro.launch.serve``.  Admission runs through the
batched `SkylineEngine`: with ``--queues Q`` it admits from Q
independent request queues in one dominance launch (`admit_many`).
With ``--stream-chunks K`` the queues instead arrive over time: K
request waves feed a `StreamingAdmitter` whose fronts live on the device
and are kept up to date by one feed wave per arrival wave, and admission
reads the final snapshot; ``--window-epochs W`` lets requests age out
after W waves (`WindowedAdmitter`).

With ``--serve-loop N`` it also runs N Poisson-arriving skyline
queries through the continuous-batching front end
(`repro_torch.serve.loop.ServeLoop`): dispatch-ahead (``--dispatch-ahead``
waves in flight), deadline-aware admission with load shedding
(``--slo-ms`` per request), and p50/p99 latency.  With
``--engine-workers`` the engine holds a 2-D (queries x workers) mesh
(`repro_torch.launch.mesh.make_engine_mesh`) and it runs one
batch of threshold-sized queries through the sharded program.

Then it builds ``--arch`` (``--smoke`` for the narrow variant), its
parameters on the device from seed 0 (`repro_torch.models.common.
init_params`), draws ``--batch`` prompts of ``--prompt-len`` tokens and
greedily decodes ``--gen`` tokens each (`generate`: one prefill, then
one `decode_step` per token, all on the device).

Every draw comes from one ``np.random.default_rng(0)`` stream in the
reference's order (the queues, the serve loop's arrivals and data, the
sharded batch, the prompts), so it admits the reference's requests and
decodes the reference's prompts.  The parameters are the port's own
draw: the reference's come from its PRNG key and a per-process salted
hash.

``--tuning PATH`` applies a kernel-tuning table to the engine
(`repro_torch.kernels.tuning`); unset, the engine consults the process
default, ``$REPRO_KERNEL_TUNING``.  ``--device`` (default: the card)
picks where the engine and the model run; nothing moves to the CPU
unless asked.

  python -m repro_torch.launch.serve --arch yi-6b --smoke --queues 2 \\
      --stream-chunks 4 --serve-loop 32 --slo-ms 200
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels.backend import available_backends, resolve_device
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.serve.scheduler import (Request, StreamingAdmitter,
                                         WindowedAdmitter, admit_many,
                                         make_default_engine)

__all__ = ["generate", "main", "parse_args"]


def generate(params, cfg, tokens, gen: int, cache_len: int):
    """Greedy decode ``gen`` tokens after prefilling ``tokens`` (B, S):
    (B, gen) int32, where the parameters lie.  Positions are made on the
    device, so the host queues every step without waiting for one."""
    tokens = tokens.to(params["embed"].device)
    caches, logits = T.prefill(params, cfg, {"tokens": tokens}, cache_len)
    s = tokens.shape[1]
    positions = torch.arange(s, s + gen, dtype=torch.int32,
                             device=tokens.device)
    out = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(gen):
        out.append(tok)
        caches, logits = T.decode_step(params, cfg, caches, tok,
                                       positions[i])
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="yi-6b",
                    help="language model to prefill and decode "
                         "(repro_torch.configs.ARCH_NAMES)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--queues", type=int, default=1,
                    help="independent request queues admitted in one "
                         "engine dispatch")
    ap.add_argument("--engine-workers", type=int, default=0,
                    help="workers axis of the skyline engine's 2-D "
                         "(queries x workers) mesh; 0 = no mesh. Admission "
                         "fronts are small and stay on the one-device "
                         "path; the mesh serves the large skyline-query "
                         "batch run here when a mesh is present")
    ap.add_argument("--shard-threshold", type=int, default=4096,
                    help="padded query length at which engine batches "
                         "route through the sharded 2-D program")
    ap.add_argument("--stream-chunks", type=int, default=0,
                    help="admit from K request waves arriving over time "
                         "instead of one static pool: each wave is one "
                         "feed wave into the device-resident admission "
                         "fronts (0 = static admission)")
    ap.add_argument("--stream-arrivals", type=int, default=0,
                    help="requests per wave per queue in --stream-chunks "
                         "mode (0 = requests / chunks)")
    ap.add_argument("--window-epochs", type=int, default=0,
                    help="with --stream-chunks: requests count toward the "
                         "front only for the last W waves (epoch-ring "
                         "sliding windows; 0 = unbounded fronts)")
    ap.add_argument("--serve-loop", type=int, default=0,
                    help="serve N Poisson-arriving skyline queries "
                         "through the continuous-batching loop and report "
                         "p50/p99 latency (0 = skip)")
    ap.add_argument("--dispatch-ahead", type=int, default=2,
                    help="serve-loop in-flight wave window (1 disables "
                         "the host-pack/device-compute overlap)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency SLO for --serve-loop; "
                         "requests predicted to miss it are shed "
                         "(0 = no deadlines)")
    ap.add_argument("--impl", default="auto",
                    choices=("auto",) + available_backends(),
                    help="kernel backend of the skyline engine ('auto': "
                         "the CUDA kernels on the card, the plain version "
                         "on the CPU)")
    ap.add_argument("--tuning", default="",
                    help="path of a kernel-tuning table "
                         "(repro_torch.kernels.tuning JSON), applied to the "
                         "engine so that impl='auto' requests run the "
                         "calibrated geometry; unset, the engine consults "
                         "$REPRO_KERNEL_TUNING")
    ap.add_argument("--device", default=None,
                    help="where the engine and the model run (default: "
                         "the card)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from repro_torch.kernels.tuning import TuningTable, default_table

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    engine_kw = {"shard_threshold_n": args.shard_threshold, "device": dev}
    if args.engine_workers:
        engine_kw["mesh"] = make_engine_mesh(workers=args.engine_workers,
                                             device=dev)
    engine = make_default_engine(SkyConfig(impl=args.impl), **engine_kw)
    if args.tuning:
        engine.kernel_tuning = TuningTable.load(args.tuning)
    mesh_desc = (dict(engine.mesh.shape) if engine.mesh is not None
                 else "none (one-device only)")
    tuned = engine.kernel_tuning or default_table()
    spec = engine.kernel_spec
    print(f"[serve] skyline engine mesh: {mesh_desc}, kernel backend: "
          f"{spec.name} (sweep={spec.sweep}, dominance={spec.dominance})"
          + (f", tuned geometries: {len(tuned)}" if tuned else ""),
          flush=True)

    # synthetic request queues with (slack, -priority, cost) criteria
    def make_queue(n):
        slack = rng.exponential(10.0, n)
        neg_priority = -rng.integers(0, 3, n)
        cost = rng.integers(8, 64, n)
        rows = np.stack([slack, neg_priority, cost]).astype(np.float32)
        cols = torch.as_tensor(rows, device=dev)
        return Request(slack=cols[0], neg_priority=cols[1], cost=cols[2])

    if args.stream_chunks > 0:
        per_wave = (args.stream_arrivals
                    or max(args.requests // args.stream_chunks, 1))
        if args.window_epochs > 0:
            adm = WindowedAdmitter(queues=args.queues, engine=engine,
                                   window_epochs=args.window_epochs)
            for wave in range(args.stream_chunks):
                adm.offer([make_queue(per_wave)
                           for _ in range(args.queues)])
                sizes = [f.shape[0] for f in adm.fronts()]
                aged = adm.tick() if wave < args.stream_chunks - 1 \
                    else False
                print(f"[serve] wave {wave}: +{per_wave} req/queue -> "
                      f"live-window front sizes {sizes}"
                      f"{' (oldest epoch aged out)' if aged else ''}")
        else:
            adm = StreamingAdmitter(queues=args.queues, engine=engine,
                                    backfill=True)
            for wave in range(args.stream_chunks):
                adm.offer([make_queue(per_wave)
                           for _ in range(args.queues)])
                sizes = [f.shape[0] for f in adm.fronts()]
                print(f"[serve] wave {wave}: +{per_wave} req/queue -> "
                      f"front sizes {sizes}")
        backfilled = (", second-layer backfilled"
                      if args.window_epochs <= 0 else "")
        for qi, batch in enumerate(adm.admit(args.batch)):
            print(f"[serve] queue {qi}: admitted {batch.shape[0]} of "
                  f"{args.stream_chunks * per_wave} streamed requests "
                  f"(front-ranked{backfilled})")
        window_note = (f"window={args.window_epochs} epochs"
                       if args.window_epochs > 0 else "unbounded window")
        print(f"[serve] streaming admission: {args.stream_chunks} insert "
              f"dispatch(es)/queue-batch ({window_note}), fronts "
              f"device-resident throughout")
    else:
        queues = [make_queue(args.requests) for _ in range(args.queues)]
        admitted = admit_many(queues, args.batch, engine=engine)
        for qi, (picked, front) in enumerate(admitted):
            print(f"[serve] queue {qi}: admitted "
                  f"{list(picked.cpu().numpy())} "
                  f"(Pareto front size {int(front.sum())})")
        print(f"[serve] engine: {engine.queries_answered} admission "
              f"queries in {engine.batches_dispatched} dispatch(es)")

    if args.serve_loop > 0:
        serve_loop(engine, rng, args)

    if engine.mesh is not None:
        # the 2-D mesh exists for large batches (admission fronts are
        # tiny and stay on the one-device path): one batch of
        # threshold-sized queries through the sharded program
        from repro_torch.serve.api import SkylineRequest
        host = np.stack([rng.random((args.shard_threshold, 4))
                         for _ in range(2)]).astype(np.float32)
        sky = torch.as_tensor(host, device=dev)
        fronts = engine.submit_many([SkylineRequest(data=x) for x in sky])
        print(f"[serve] sharded skyline batch: {len(fronts)} queries of "
              f"n={args.shard_threshold} -> "
              f"{engine.sharded_dispatched} sharded dispatch(es), "
              f"front sizes {[int(b.count) for b, _ in fronts]}")

    # the model is made after the admission, whose latencies it would
    # otherwise queue behind; it draws nothing from `rng`
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(T.lm_plan(cfg), seed=0, device=dev)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(
            np.int32), device=dev)
    t0 = time.time()
    toks = generate(params, cfg, prompts, args.gen,
                    args.prompt_len + args.gen).cpu()
    dt = time.time() - t0
    print(f"[serve] generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)", flush=True)
    assert toks.shape == (args.batch, args.gen)


def serve_loop(engine, rng, args) -> None:
    """``--serve-loop``: N queries of 256 x 4 host rows arriving at
    exponential gaps of mean 5 ms, each with a deadline ``--slo-ms``
    after its arrival; prints p50/p99 of the answered ones."""
    from repro_torch.serve.api import SkylineRequest
    from repro_torch.serve.loop import ServeLoop
    slo = args.slo_ms / 1e3 if args.slo_ms > 0 else None
    arrivals = np.cumsum(rng.exponential(0.005, args.serve_loop))
    with ServeLoop(engine, depth=args.dispatch_ahead) as sloop:
        t0 = time.monotonic()
        tickets = []
        for dt_arr in arrivals:
            while time.monotonic() - t0 < dt_arr:
                time.sleep(0.0005)
            now = time.monotonic()
            tickets.append(sloop.submit(SkylineRequest(
                data=rng.random((256, 4)).astype(np.float32),
                deadline=None if slo is None else now + slo)))
        sloop.drain()
        lats = sorted(t.latency for t in tickets if t.status == "ok")
        shed = sum(t.status == "shed" for t in tickets)
        if lats:
            p50 = lats[len(lats) // 2] * 1e3
            p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3
            print(f"[serve] serve-loop: {len(lats)} ok / {shed} shed, "
                  f"p50 {p50:.1f}ms p99 {p99:.1f}ms, "
                  f"{sloop.stats['waves']} waves "
                  f"(depth={args.dispatch_ahead})")
        else:
            print(f"[serve] serve-loop: all {shed} requests shed "
                  f"(SLO {args.slo_ms}ms infeasible on this host)")


if __name__ == "__main__":
    main()
