"""The port's spans (``gswm_torch.utils.profiling.span``) as the benchmark
reads them: recorded under a CPU ``torch.profiler`` as host operations that
``h100bench.trace.read`` keeps, nested in time; the span tree of the tiny
presets' extraction and guided generation; the ``program_span`` readers
(``h100bench/metrics/``) on hand-built traces with exact values.

The first tests pin the behaviour of the private profiler API behind
``span``: a torch upgrade that changes it fails here."""

import json
import pathlib
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gswm_torch.config import GSConfig
from gswm_torch.core.embed import embed_latents
from gswm_torch.models.layers import GroupNorm32
from gswm_torch.pipelines.inversable import InversablePipeline
from gswm_torch.utils import profiling
from h100bench import cells, run, trace
from h100bench import spans as spanlib

STEPS = 3


def _traced(fn):
    """``fn()`` under a CPU profiler, inside the benchmark's ``request``
    range; the ``Trace`` that ``trace.read`` makes of it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("request"):
            fn()
    return trace.read(prof, ())


def _named(tr, name):
    return [(s, e) for n, s, e in tr.host_ops if n == name]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


# -- the span facility -------------------------------------------------------


def test_span_is_a_host_op_nested_in_its_parent():
    def work():
        with profiling.span("gswm.test.outer"):
            x = torch.ones(8, 8) @ torch.ones(8, 8)
            with profiling.span("gswm.test.inner"):
                x + 1

    tr = _traced(work)
    (outer,), (inner,) = _named(tr, "gswm.test.outer"), _named(tr, "gswm.test.inner")
    assert _inside(inner, outer) and inner != outer
    (add,) = _named(tr, "aten::add")
    assert _inside(add, inner)
    assert not any(n.startswith("gswm.test") for n, *_ in tr.ranges)


def test_host_op_at_names_the_span_python_is_in():
    def work():
        with profiling.span("gswm.test.outer"):
            torch.ones(4)
            with profiling.span("gswm.test.python"):
                _spin(0.02)
            torch.ones(4)

    tr = _traced(work)
    ((s, e),) = _named(tr, "gswm.test.python")
    hosts = sorted(tr.host_ops, key=lambda o: o[1])
    assert tr.host_op_at((s + e) / 2, hosts, [o[1] for o in hosts]) == "gswm.test.python"


def test_span_without_a_profiler_records_nothing():
    with profiling.span("gswm.test.unprofiled"):
        y = torch.ones(3) * 2
    assert torch.equal(y, torch.full((3,), 2.0))

    tr = _traced(lambda: torch.ones(2))
    assert not _named(tr, "gswm.test.unprofiled")


def test_span_closes_on_an_exception():
    def work():
        with pytest.raises(ValueError, match="inside"):
            with profiling.span("gswm.test.raises"):
                raise ValueError("inside")
        _spin(0.005)
        torch.ones(2)

    tr = _traced(work)
    ((s, e),) = _named(tr, "gswm.test.raises")
    (ones,) = _named(tr, "aten::ones")
    assert e <= ones[0]


def test_stage_opens_a_span_of_its_name():
    def work():
        with profiling.stage("gswm.test.stage", device="cpu"):
            torch.ones(2)

    tr = _traced(work)
    (stage,) = _named(tr, "gswm.test.stage")
    assert _inside(_named(tr, "aten::ones")[0], stage)
    assert profiling.stage_report(reset=True)["gswm.test.stage"]["count"] == 1
    assert not hasattr(profiling, "print_stage_report")


def test_the_private_api_sits_behind_span_alone():
    root = pathlib.Path(profiling.__file__).resolve().parents[1]
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "torch._C._profiler" in p.read_text())
    assert users == ["utils/profiling.py"]


# -- the span tree of a request ----------------------------------------------


def _gs_config(preset):
    f = 2 ** (len(preset.vae.block_out_channels) - 1)
    return GSConfig(key_hex="5a" * 32, nonce_hex="a5" * 16, message_bits=32, width=64,
                    height=64, vae_scale=f, channels=preset.vae.latent_channels)


def _groupnorms_run(pipe, fn):
    """``fn()``, and the number of GroupNorm32 calls it made."""
    calls = []
    handles = [m.register_forward_hook(lambda *a: calls.append(1))
               for part in (pipe.unet, pipe.vae) for m in part.modules()
               if isinstance(m, GroupNorm32)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return len(calls)


def _extract():
    torch.manual_seed(0)
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    cfg = _gs_config(pipe.preset)
    images = torch.rand(2, 3, 64, 64)

    def request():
        pipe.extract_bits(cfg, images=images, num_steps=STEPS)

    request()  # the empty prompt's context encoded and cached, as in a warm-up
    holder = {}
    holder["groupnorms"] = _groupnorms_run(pipe, lambda: holder.update(tr=_traced(request)))
    return holder["tr"], holder["groupnorms"], ("gswm.extract_bits",)


def _generate():
    torch.manual_seed(0)
    pipe = InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32)
    cfg = _gs_config(pipe.preset)
    ids = pipe.text.empty_prompt_ids(1)

    def request():
        z, _ = embed_latents(cfg, batch=1, u=torch.rand(1, cfg.total_elements),
                             replicate=False, device="cpu")
        pipe.generate(z, prompt_ids=ids, guidance_scale=7.5, num_steps=STEPS)

    request()
    holder = {}
    holder["groupnorms"] = _groupnorms_run(pipe, lambda: holder.update(tr=_traced(request)))
    return holder["tr"], holder["groupnorms"], ("gswm.embed", "gswm.generate")


@pytest.fixture(scope="module", params=["extract", "generate"])
def request_trace(request):
    tr, groupnorms, roots = {"extract": _extract, "generate": _generate}[request.param]()
    spans = [(n, s, e) for n, s, e in tr.host_ops if n.startswith("gswm.")]
    return types.SimpleNamespace(kind=request.param, trace=tr, spans=spans,
                                 groupnorms=groupnorms, roots=roots)


NAMES = {
    "extract": {"gswm.extract_bits", "gswm.vae.encode", "gswm.loop", "gswm.step", "gswm.unet",
                "gswm.groupnorm", "gswm.attn.self", "gswm.attn.cross", "gswm.decode_bits"},
    "generate": {"gswm.embed", "gswm.generate", "gswm.text", "gswm.loop", "gswm.step",
                 "gswm.unet", "gswm.groupnorm", "gswm.attn.self", "gswm.attn.cross",
                 "gswm.vae.decode"},
}


def _of(rt, name):
    return [(s, e) for n, s, e in rt.spans if n == name]


def test_request_records_exactly_its_spans(request_trace):
    assert {n for n, _, _ in request_trace.spans} == NAMES[request_trace.kind]


def test_one_unet_a_step_and_steps_under_the_loop(request_trace):
    (loop,) = _of(request_trace, "gswm.loop")
    steps, unets = _of(request_trace, "gswm.step"), _of(request_trace, "gswm.unet")
    assert len(steps) == len(unets) == STEPS
    for step in steps:
        assert _inside(step, loop)
        assert sum(_inside(u, step) for u in unets) == 1


def test_groupnorm_spans_equal_the_groupnorms_run(request_trace):
    assert len(_of(request_trace, "gswm.groupnorm")) == request_trace.groupnorms > 0


def test_cross_attention_only_inside_the_unet(request_trace):
    unets = _of(request_trace, "gswm.unet")
    cross = _of(request_trace, "gswm.attn.cross")
    assert cross and all(any(_inside(c, u) for u in unets) for c in cross)
    assert all(any(_inside(a, u) for u in unets) for a in _of(request_trace, "gswm.attn.self"))


def test_every_span_inside_its_requests_root(request_trace):
    roots = {n: _of(request_trace, n) for n in request_trace.roots}
    assert all(len(r) == 1 for r in roots.values())
    main = roots[request_trace.roots[-1]][0]
    for n, s, e in request_trace.spans:
        if n not in request_trace.roots:
            assert _inside((s, e), main), n


def test_text_span_counts_the_prompts_encoded(request_trace):
    want = {"extract": 0, "generate": 1}[request_trace.kind]  # the empty prompt is cached
    assert len(_of(request_trace, "gswm.text")) == want


# -- the readers -------------------------------------------------------------


def _run(tr, requests=1, steps=2, batch=2):
    cell = types.SimpleNamespace(mix={"steps": steps, "batch": batch})
    return run.Run(cell=cell, requests=requests, images=requests * batch, window_s=tr.window_s,
                   setup_s=0.0, peak_bytes=0, trace=tr)


def _hand_trace():
    """Two UNet forwards, the second blocked 0.5 s on a full queue; a
    GroupNorm and both kinds of attention inside each; one VAE GroupNorm."""
    host = [
        ("gswm.unet", 1.0, 3.0), ("gswm.groupnorm", 1.1, 1.2), ("gswm.attn.self", 1.3, 1.5),
        ("gswm.attn.cross", 1.6, 1.7),
        ("gswm.unet", 4.0, 7.0), ("gswm.groupnorm", 4.1, 4.2), ("gswm.attn.self", 4.3, 4.5),
        ("Command Buffer Full", 4.35, 4.85), ("gswm.attn.cross", 5.0, 5.1),
        ("gswm.groupnorm", 8.0, 8.5),
        ("Command Buffer Full", 7.5, 7.9),   # outside every gswm.unet span
        ("gswm.unet", 9.5, 10.5),            # outside the window
    ]
    device = [  # (name, start, end, launch)
        ("conv", 1.05, 1.25, 1.05), ("gn", 1.25, 1.35, 1.15), ("qkv", 1.35, 1.55, 1.35),
        ("flash", 1.55, 1.95, 1.45), ("mm", 1.95, 2.05, 1.65), ("out", 2.05, 2.1, 2.9),
        ("gn", 4.15, 4.25, 4.15), ("flash", 4.4, 4.8, 4.4), ("mm", 5.05, 5.15, 5.05),
        ("conv", 5.2, 5.5, 6.0), ("copy", 5.5, 5.6, None),
        ("gn", 8.2, 8.4, 8.2), ("gn", 8.4, 8.45, 8.4), ("after", 9.0, 9.1, 8.9),
    ]
    return trace.Trace(window=(0.0, 9.0), device_ops=device, ranges=[("request", 0.0, 9.0)],
                       host_ops=host)


def _read(metric, run_):
    return cells.reader(metric)(run_, metric)


def test_spans_in_the_window_by_start():
    tr = _hand_trace()
    assert spanlib.spans(tr, "gswm.unet") == [(1.0, 3.0), (4.0, 7.0)]
    assert spanlib.spans(tr, ("gswm.attn.cross", "gswm.attn.self")) == \
        [(1.3, 1.5), (1.6, 1.7), (4.3, 4.5), (5.0, 5.1)]
    assert spanlib.spans(tr, "gswm.missing") == []


def test_device_in_counts_each_operation_once_over_nested_spans():
    tr = _hand_trace()
    # a span nested in another adds nothing; the copy without a launch is left out
    count, seconds = spanlib.device_in(tr, [(1.0, 3.0), (1.1, 1.2), (4.0, 7.0)])
    assert count == 10 and seconds == pytest.approx(1.95, abs=1e-12)
    assert spanlib.device_in(tr, [(8.0, 8.5)]) == (2, pytest.approx(0.25, abs=1e-12))
    assert spanlib.device_in(tr, []) == (0, 0.0)


def test_host_s_inside_cuts_at_the_span():
    tr = _hand_trace()
    assert spanlib.host_s_inside(tr, [(4.0, 7.0)], "Command Buffer Full") == \
        pytest.approx(0.5, abs=1e-12)
    assert spanlib.host_s_inside(tr, [(4.0, 4.5)], "Command Buffer Full") == \
        pytest.approx(0.15, abs=1e-12)
    assert spanlib.host_s_inside(tr, [(1.0, 3.0)], "Command Buffer Full") == 0.0


def test_unet_launches_reads_the_launches_a_forward():
    assert _read("unet_launches.extract", _run(_hand_trace())) == 5.0


def test_unet_enqueue_ms_leaves_out_the_full_queue():
    # (2.0 + 3.0 - 0.5) s over two forwards; the full queue at 7.5 s lies outside
    assert _read("unet_enqueue_ms.generate", _run(_hand_trace())) == pytest.approx(2250.0)


def test_groupnorm_device_ms_reads_unet_and_vae_groupnorms():
    # 0.1 + 0.1 + 0.2 + 0.05 s over 2 images
    assert _read("groupnorm_device_ms.extract", _run(_hand_trace())) == pytest.approx(225.0)


def test_attn_device_ms_reads_self_and_cross_attention():
    # self 0.2 + 0.4 + 0.4, cross 0.1 + 0.1 s over 1 request x 2 steps x 2 images
    assert _read("attn_device_ms.generate", _run(_hand_trace())) == pytest.approx(300.0)


@pytest.mark.parametrize("metric", ["unet_launches.extract", "unet_enqueue_ms.generate",
                                    "groupnorm_device_ms.generate", "attn_device_ms.extract"])
def test_a_reader_returns_none_without_its_spans(metric):
    hand = _hand_trace()
    bare = trace.Trace(window=hand.window, device_ops=hand.device_ops, ranges=hand.ranges,
                       host_ops=[o for o in hand.host_ops if not o[0].startswith("gswm.")])
    assert _read(metric, _run(bare)) is None
    untraced = run.Run(cell=None, requests=1, images=1, window_s=1.0, setup_s=0.0, peak_bytes=0)
    assert _read(metric, untraced) is None


@pytest.mark.parametrize("metric", ["unet_launches.generate", "groupnorm_device_ms.extract",
                                    "attn_device_ms.generate"])
def test_a_device_reader_returns_none_without_device_operations(metric):
    hand = _hand_trace()
    host_only = trace.Trace(window=hand.window, device_ops=[], ranges=hand.ranges,
                            host_ops=hand.host_ops)
    assert _read(metric, _run(host_only)) is None


def _tiny_bench_with_spans(tmp_path):
    """The tiny cells' ``BENCHMARK.json`` with the root file's ``program_span``
    metrics appended, each listing the tiny cells that report what it moves."""
    data = cells.HERE / "tests" / "data"
    tiny = json.loads((data / "BENCHMARK.json").read_text())
    root = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    for m in root["per_layer"]:
        if m["source"] == "program_span":
            tiny["per_layer"].append(dict(m, workloads=[
                w["name"] for w in tiny["workloads"]
                if cells.reports(next(e for e in tiny["end_to_end"] if e["name"] == m["moves"]),
                                 w["name"], set())]))
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(tiny))
    return bench, data


def test_traced_cpu_run_lists_the_enqueue_time(tmp_path):
    bench, data = _tiny_bench_with_spans(tmp_path)
    torch.set_num_threads(2)
    cell = cells.load("tiny-extract", bench=bench, here=data)
    res = run.run_cell(cell, 2 ** 31 + 7, 0.05, True, "cpu")
    assert res["correct"] is True
    enqueue = res["metrics"]["unet_enqueue_ms.extract"]
    assert enqueue["unit"] == "ms" and enqueue["value"] > 0
    # the CPU trace has no device operations: the device readers report nothing
    assert not {"unet_launches.extract", "groupnorm_device_ms.extract",
                "attn_device_ms.extract"} & set(res["metrics"])
