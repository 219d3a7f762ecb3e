"""Serving launcher: thin adapter over ``repro_torch.serving`` (port of
``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch ARCH [--smoke] \
        [--sparsity 2:4 --mode dense|compressed|gather] [--quantize int8|fp8 [--static-scales]] \
        [--kernel-backend auto|cuda|torch] [--device cuda|cpu] \
        [--batch 4] [--max-len 64] [--requests 8] [--new-tokens 8] \
        [--block-len 8] [--kv-blocks N] [--admission reserve|optimistic] \
        [--prefill-chunk 8] [--rate 1.0] [--seed 0] [--mesh 1xM]
    python -m repro_torch.launch.serve --artifact DIR [--kernel-backend ...]

``ARCH`` is one of ``repro_torch.configs.ARCH_IDS`` with a token
frontend: internlm2_1_8b, gemma3_1b, starcoder2_3b, mistral_large_123b,
qwen3_moe_235b_a22b, dbrx_132b, mamba2_2_7b (ssm: Mamba-2 layers, no
attention, one recurrent state per slot) and jamba_1_5_large_398b
(hybrid: Mamba + MLP, Mamba + MoE and attention layers; its full width
does not fit one card, ``--smoke`` runs on the CPU).  It builds a :class:`repro_torch.serving.ServingSpec`, initialises random
weights from a seeded ``torch.Generator`` on the device, runs
:func:`repro_torch.serving.prepare` (``--quantize int8|fp8`` quantizes
every linear per output channel, to int8 or float8_e4m3fn, and the cuda
tier runs that class's kernels, w8a8 or e4m3 x e4m3; ``--static-scales``
then calibrates one
activation scale per linear site on a seeded batch of ``(batch,
min(max_len, 32))`` tokens), and hands the result to
:class:`repro_torch.serving.Engine` over a seeded Poisson trace.  With
``--artifact`` it serves a converted checkpoint (``python -m
repro.launch.convert``) instead: the manifest supplies the config and the
spec, so the layout and quantize flags are ignored and only the backend
overrides.  It runs on the CUDA device unless ``--device cpu`` is given,
and fails when no CUDA device is present.  The report lines are the JAX
launcher's.

``--mesh 1xM`` serves tensor-parallel over M ranks (``ServingSpec.mesh``;
a data axis > 1 is refused): the kernels are built once here, then M
processes are spawned (``launch.mesh.spawn_ranks``: rank r on
``cuda:(r % device_count)``, NCCL when every rank has its own card, gloo
when they share one or run on the CPU), each prepares its shard and runs
the same Engine; rank 0 prints the report.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--artifact", default=None, metavar="ARTIFACT_DIR",
                    help="serve a converted checkpoint artifact instead of random "
                         "init; its manifest supplies the config and ServingSpec "
                         "(layout/quantize flags are ignored, --kernel-backend "
                         "still overrides)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sparsity", default=None)
    ap.add_argument("--mode", default="compressed", choices=["dense", "compressed", "gather"])
    ap.add_argument("--quantize", default=None, choices=["int8", "fp8"],
                    help="quantize every linear's values to int8 or fp8 (e4m3) with "
                         "per-channel scales; activations are quantized to the same "
                         "dtype per row (or against static scales)")
    ap.add_argument("--static-scales", action="store_true",
                    help="with --quantize: calibrate static activation scales on one "
                         "batch so decode skips the per-row absmax pass")
    ap.add_argument("--kernel-backend", default="auto", choices=["auto", "cuda", "torch"],
                    help="dispatch-engine backend override")
    ap.add_argument("--device", default=None,
                    help="serving device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions or the torch tier)")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--block-len", type=int, default=8, help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="total KV block budget (default: every slot at --max-len)")
    ap.add_argument("--admission", default="reserve", choices=["reserve", "optimistic"])
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate (requests per scheduler iteration)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="tensor-parallel serving over a (data, model) mesh, e.g. 1x2: "
                         "M ranks on this host (data must be 1)")
    args = ap.parse_args(argv)
    if args.static_scales and not args.quantize:
        ap.error("--static-scales requires --quantize int8|fp8")
    if not args.arch and not args.artifact:
        ap.error("need --arch (random init) or --artifact (converted checkpoint)")
    if args.mesh and args.artifact:
        ap.error("--mesh serves --arch models (an artifact's spec carries its own)")

    from repro_torch import serving

    device = serving.resolve_device(args.device)
    if not args.mesh:
        return _serve(args, device)
    from repro_torch.launch import mesh as tmesh

    _, m = tmesh.parse_mesh(args.mesh)
    if device.type == "cuda" and args.kernel_backend != "torch":
        from repro_torch.kernels import _build
        _build.build_all()          # once, before the ranks: they only load
    backend = tmesh.backend_for(m, device.type)
    ranks = ", ".join(f"rank {r} -> {tmesh.rank_device(r, device.type)}" for r in range(m))
    print(f"mesh 1x{m}: {m} ranks over torch.distributed ({backend}; {ranks})")
    tmesh.spawn_ranks(_serve_rank, m, args, device_type=device.type)
    return None


def _serve_rank(rank, world, device, args):
    _serve(args, device, rank=rank)


def _serve(args, device, rank: int = 0):
    """Prepare and serve on ``device``; under ``--mesh`` this is one rank
    (rank 0 prints)."""
    import torch

    from repro_torch import serving
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params

    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh
        mesh = parse_mesh(args.mesh)
    if args.artifact:
        backend = args.kernel_backend if args.kernel_backend != "auto" else None
        with torch.inference_mode():
            prepared = serving.prepare_from_artifact(args.artifact, backend=backend,
                                                     device=device)
        spec, cfg = prepared.spec, prepared.cfg
        say(f"artifact {args.artifact}: config {cfg.name}, spec "
            f"{spec.layout}/{spec.sparsity}/{spec.qdtype}")
    else:
        sparsity = tuple(map(int, args.sparsity.split(":"))) if args.sparsity else None
        spec = serving.ServingSpec(
            layout=args.mode, sparsity=sparsity, qdtype=args.quantize,
            static_scales=args.static_scales, mesh=mesh, backend=args.kernel_backend,
            slots=args.batch, max_len=args.max_len,
            block_len=args.block_len, kv_blocks=args.kv_blocks,
            admission=args.admission, prefill_chunk=args.prefill_chunk)
        base = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        cfg = spec.apply_to(base)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        calib_tokens = None
        if args.static_scales:
            calib_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
            calib_tokens = torch.randint(1, cfg.vocab_size,
                                         (args.batch, min(args.max_len, 32)),
                                         generator=calib_gen, device=device)
        with torch.inference_mode():
            params = init_params(gen, cfg, device=device)
            prepared = serving.prepare(params, spec, cfg=cfg, calib_tokens=calib_tokens,
                                       device=device)
        del params
    if prepared.calibrated_sites:
        say(f"static activation scales calibrated for {prepared.calibrated_sites} "
            f"linear site(s) — decode skips the per-row absmax pass")
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(prepared.params))
    sp_str = f"{spec.sparsity[0]}:{spec.sparsity[1]}" if spec.sparsity else "dense"
    q_str = f"/{spec.qdtype}" if spec.qdtype else ""
    say(f"serving {cfg.name}: {nbytes / 1e6:.1f} MB weights{' per rank' if mesh else ''} "
        f"({sp_str}/{spec.layout}{q_str}) on {device}")
    if mesh:
        say(f"mesh installed: data={mesh[0]} x model={mesh[1]} ({mesh[1]} ranks)")
    say("dispatch engine plan:")
    for line in prepared.dispatch_report():
        say(line)
    engine = serving.Engine(prepared)
    say(f"paged KV: {engine.num_blocks} block(s) x {spec.block_len} tokens, "
        f"{engine.kv_bytes() / 1e6:.1f} MB pools{' per rank' if mesh else ''}, "
        f"admission={spec.admission}")
    trace = serving.make_poisson_trace(
        seed=args.seed, num_requests=args.requests, rate=args.rate,
        new_mix=((args.new_tokens, 1.0),), vocab_size=cfg.vocab_size)
    report = engine.run(trace)
    say(f"served {report.describe()}")
    per_req = ", ".join(f"r{s.rid}:{s.tokens_per_s:.1f}" for s in report.stats[:8])
    say(f"per-request tokens/s: {per_req}{' ...' if len(report.stats) > 8 else ''}")
    say(f"completed-request throughput: {report.completed_per_call:.3f} "
        f"requests/model-call, {report.completed / report.wall_s:.2f} requests/s")
    if mesh:
        say(f"token streams equal on all {mesh[1]} ranks")
    return report


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
