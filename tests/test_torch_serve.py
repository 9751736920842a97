"""The port's ``BatchedServer`` against the JAX package's on the CPU.

Both smoke configs at ``compute_dtype="float32"``, the JAX ``build_lm``
weights carried across by ``lm_params_from_numpy``, and one fixed request
mix: prompt lengths that are and are not multiples of RWKV-6's 64-token
chunk (so the chunked WKV path and the sequential one both serve), more
requests than lanes (so lanes are refilled), and prompts longer than
RecurrentGemma's 8-token smoke window (so the ring cache wraps). Greedy
decoding must emit the same tokens in both packages.
"""

import dataclasses

import numpy as np
import jax
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_lm as jax_build_lm
from repro.serve import BatchedServer as JaxBatchedServer
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import build_lm
from repro_torch.obs import MetricsRegistry, metrics
from repro_torch.serve import BatchedServer, make_serve_fns

ARCHS = ["rwkv6-3b", "recurrentgemma-2b"]
PROMPT_LENS = (64, 5, 128, 12, 64, 30)
MAX_NEW = 6


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve(server, prompts):
    rids = [server.submit(p, MAX_NEW) for p in prompts]
    done = {r.rid: r for r in server.run_until_idle()}
    return [done[rid].out_tokens for rid in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_the_jax_server(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params, _ = jax_build_lm(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxBatchedServer(jcfg, params, lanes=2, max_len=160), prompts)
    srv = BatchedServer(cfg, model, lanes=2, max_len=160)
    got = _serve(srv, prompts)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got)
    assert srv.stats == {"prefills": len(prompts), "decode_steps": len(prompts) * (MAX_NEW - 1),
                         "tokens_out": len(prompts) * (MAX_NEW - 1)}


def test_server_telemetry_and_determinism():
    cfg = get_smoke_config("recurrentgemma-2b")
    model = build_lm(cfg, seed=3, device="cpu")
    reg = MetricsRegistry()
    with metrics.using(reg):
        srv = BatchedServer(cfg, model, lanes=3, max_len=64)
        first = _serve(srv, _prompts(cfg.vocab_size, seed=1)[1::2])
    again = _serve(BatchedServer(cfg, model, lanes=1, max_len=64),
                   _prompts(cfg.vocab_size, seed=1)[1::2])
    assert first == again  # greedy decoding does not depend on the lane layout
    assert reg.counters["serve.prefills"] == 3
    assert reg.counters["serve.decode_steps"] == 3 * (MAX_NEW - 1)
    assert reg.timers["serve.prefill"].count == 3
    assert reg.gauges["serve.batch_occupancy"] == 0.0
    assert reg.gauges["serve.items_per_sec"] > 0


def test_requests_stop_at_max_len():
    cfg = get_smoke_config("rwkv6-3b")
    srv = BatchedServer(cfg, build_lm(cfg, seed=0, device="cpu"), lanes=1, max_len=16)
    srv.submit(np.arange(10, dtype=np.int32), max_new_tokens=100)
    (req,) = srv.run_until_idle()
    assert req.done and len(req.out_tokens) == 16 - 1 - 10 + 1
    assert req.prefill_s > 0 and req.items_per_sec > 0


def test_make_serve_fns_defaults_to_the_card():
    prefill, decode, cache_init = make_serve_fns(get_smoke_config("rwkv6-3b"), batch=1,
                                                 max_len=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cache_init()


def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--requests", "3",
          "--lanes", "2", "--max-len", "80", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "on cpu" in out
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["--arch", "rwkv6-3b", "--smoke"])  # the card by default
