"""The plain reference held to a hand-built two-layer example, its optimizer
to the port's, and the control (the reference in float8) to the cells'
limits at a size the CPU holds."""
import json
import math
import os

import pytest
import torch

from conftest import BENCH
from reference import model as ref
from reference import train as rtrain
from reference.weights import dims, make_weights


def fixture(name):
    with open(os.path.join(BENCH, "tests", "fixtures", f"{name}.json")) as fh:
        return json.load(fh)


def by_hand(w, m, tokens):
    """float64 logits of every position, one token and one head at a time."""
    f = {k: v.double() for k, v in w.items()}
    S, d = len(tokens), m["d"]
    H, Hkv, D = m["H"], m["Hkv"], m["D"]
    x = [f["embed"][t].clone() for t in tokens]

    def norm(v, g):
        return v / torch.sqrt((v * v).mean() + m["eps"]) * g

    def rot(v, p):                                  # v [D]: pairs (i, i + D/2)
        out = v.clone()
        for i in range(D // 2):
            a = p / m["theta"] ** (2 * i / D)
            out[i] = v[i] * math.cos(a) - v[i + D // 2] * math.sin(a)
            out[i + D // 2] = v[i] * math.sin(a) + v[i + D // 2] * math.cos(a)
        return out

    for l in range(m["L"]):
        h = [norm(v, f["ln1"][l]) for v in x]
        q = [(hv @ f["q"][l]).view(H, D) for hv in h]
        k = [(hv @ f["k"][l]).view(Hkv, D) for hv in h]
        v = [(hv @ f["v"][l]).view(Hkv, D) for hv in h]
        q = [torch.stack([rot(qt[j], t) for j in range(H)]) for t, qt in enumerate(q)]
        k = [torch.stack([rot(kt[j], t) for j in range(Hkv)]) for t, kt in enumerate(k)]
        new = []
        for t in range(S):
            heads = []
            for j in range(H):
                g = j // (H // Hkv)
                s = torch.stack([q[t][j] @ k[u][g] for u in range(t + 1)]) / math.sqrt(D)
                p = torch.exp(s - s.max())
                p = p / p.sum()
                heads.append(sum(p[u] * v[u][g] for u in range(t + 1)))
            new.append(x[t] + torch.cat(heads) @ f["o"][l])
        x = new
        out = []
        for t in range(S):
            h2 = norm(x[t], f["ln2"][l])
            if m["moe"]:
                probs = torch.softmax(h2 @ f["router"][l], -1)
                order = sorted(range(m["E"]), key=lambda e: (-float(probs[e]), e))[:m["top_k"]]
                gates = probs[order] / probs[order].sum()
                y = sum(g * (torch.nn.functional.silu(h2 @ f["w_gate"][l][e])
                             * (h2 @ f["w_up"][l][e])) @ f["w_down"][l][e]
                        for g, e in zip(gates, order))
            else:
                y = (torch.nn.functional.silu(h2 @ f["w_gate"][l]) * (h2 @ f["w_up"][l])) \
                    @ f["w_down"][l]
            out.append(x[t] + y)
        x = out
    head = f["lm_head"] if "lm_head" in f else f["embed"].T    # tied: the embedding
    return torch.stack([norm(v, f["final_norm"]) @ head for v in x])


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_forward_matches_the_hand_built_two_layer_model(name):
    cfg = fixture(name)
    m = dims(cfg)
    w = make_weights(cfg, 7, "cpu")
    # spread the norm gains so that a gain applied to the wrong axis shows
    for n in ("ln1", "ln2", "final_norm"):
        w[n].copy_(1.0 + 0.25 * torch.randn(w[n].shape, generator=torch.Generator().manual_seed(3)))
    tokens = torch.tensor([5, 17, 200, 3, 3, 90, 41])
    want = by_hand(w, m, tokens.tolist())
    got = ref.logits_at(w, m, tokens, torch.arange(len(tokens)), q_block=3)
    assert torch.allclose(got.double(), want, atol=2e-5, rtol=1e-5), (got.double() - want).abs().max()


def test_served_gaps_read_the_reference_best():
    cfg = fixture("tiny-dense")
    m = dims(cfg)
    w = make_weights(cfg, 8, "cpu")
    prompt = torch.tensor([1, 2, 3, 4])
    logits = ref.logits_at(w, m, prompt, torch.tensor([3]))
    best = int(logits.argmax())
    g = ref.served_gaps(w, m, prompt, torch.tensor([best]))
    assert g["program"] == [0.0]
    worst = int(logits.argmin())
    g = ref.served_gaps(w, m, prompt, torch.tensor([worst]))
    assert g["program"][0] == pytest.approx(float(logits.max() - logits.min()))


def test_gradients_match_float64_autograd_of_the_hand_built_model():
    cfg = fixture("tiny-dense")
    m = dims(cfg)
    w = make_weights(cfg, 9, "cpu")
    tokens = torch.tensor([[3, 9, 27, 81], [5, 25, 125, 1]])
    labels = torch.tensor([[9, 27, 81, 243], [25, 125, 1, 6]])
    loss, grads = rtrain.loss_and_grads(w, cfg, tokens, labels, row_block=3)
    live = {n: t.detach().double().requires_grad_(True) for n, t in w.items()}
    total = 0
    for b in range(2):
        lg = by_hand(live, m, tokens[b].tolist())
        total = total + (torch.logsumexp(lg, -1) - lg[torch.arange(4), labels[b]]).sum()
    (total / 8).backward()
    assert float(loss) == pytest.approx(float(total.detach() / 8), rel=1e-5)
    for name, t, _ in rtrain.leaves(w, cfg):
        base, _, layer = name.partition(".")
        want = live[base].grad if not layer else live[base].grad[int(layer)]
        assert torch.allclose(grads[name].double(), want, atol=1e-6, rtol=1e-4), name


def test_int8_codec_by_hand():
    x = torch.tensor([[0.5, -1.27, 0.0, 1.27, 0.004, 0.006]])
    q, s = rtrain.quantize(x, "m", block=4)
    assert s[0].tolist() == pytest.approx([0.01, 0.006 / 127])
    assert q.tolist() == [[50, -127, 0, 127, 85, 127]]
    v = torch.tensor([[4.0, 1.0, 0.0, 0.25]])
    q, s = rtrain.quantize(v, "v", block=4)      # on the sqrt scale, rounded up
    assert s[0].tolist() == pytest.approx([2.0 / 127])
    assert q.tolist() == [[127, 64, 0, 32]]
    assert rtrain.dequantize(q, s, "v", block=4)[0, 0] == pytest.approx(4.0)


@pytest.mark.parametrize("moments", ["int8", "float32"])
def test_adamw_matches_the_port_bit_for_bit(moments):
    from repro_torch.launch.steps import lr_schedule
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    gen = torch.Generator().manual_seed(11)
    p0 = torch.randn(6, 300, generator=gen).to(torch.bfloat16)
    g = [torch.randn(6, 300, generator=gen) * 1e-3 for _ in range(3)]
    cfg = AdamWConfig(moment_dtype=moments)
    port_p, state = {"w": p0.clone()}, adamw_init({"w": p0}, cfg)
    mine = rtrain.AdamW()
    mine_p = p0.clone()
    for i in range(3):
        lr = lr_schedule(torch.tensor(i), 3e-4, warmup=100)
        assert float(lr) == float(rtrain.lr_at(i, 3e-4, 100))
        port_p, state = adamw_update({"w": g[i]}, port_p, state, lr, cfg)
        if moments == "int8":
            mine.step([("w", mine_p, True)], {"w": g[i]}, lr)
            assert torch.equal(port_p["w"], mine_p), i
    for s in (0, 1, 99, 100, 5000):
        assert float(lr_schedule(torch.tensor(s), 3e-4, warmup=100)) == float(rtrain.lr_at(s, 3e-4, 100))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell,conf", [("phi4-mini.rag", "mid-dense"),
                                       ("qwen3-moe.chat", "mid-moe")])
def test_the_control_fails_a_serving_cells_limits(cell, conf, seed):
    """The control (the reference in float8, put in the program's place)
    fails the cell's own limits at a mid size the CPU holds (8 dense or 4
    MoE layers, 64 experts, top 8): the gap of its first token at 256
    positions of a random sequence."""
    from harness import correct

    with open(os.path.join(BENCH, "limits", f"{cell}.json")) as fh:
        limits = json.load(fh)
    cfg = fixture(conf)
    m = dims(cfg)
    w = make_weights(cfg, seed, "cpu")
    toks = torch.randint(0, m["V"], (320,), generator=torch.Generator().manual_seed(seed))
    low = ref.served_gaps(w, m, toks[:64], toks[64:], control="fp8")["control"]
    assert not correct.judge(correct.gap_numbers(low), limits)


def test_the_control_and_half_a_batch_fail_the_training_limits():
    from harness import correct, train

    with open(os.path.join(BENCH, "limits", "phi4-mini.train.json")) as fh:
        limits = json.load(fh)
    cfg, traffic = fixture("tiny-dense"), fixture("tiny-train")
    rec = train.run(cfg, traffic, 29, 0.0, False, torch.device("cpu"), 0.0)
    ref32 = correct.train_reference(cfg, traffic, 29, "cpu")
    low = correct.train_reference(cfg, traffic, 29, "cpu", "fp8")
    half = correct.train_reference(cfg, traffic, 29, "cpu", rows=1)
    assert not correct.judge(correct.compare_train(low, ref32), limits)
    assert not correct.judge(correct.compare_train(half, ref32), limits)
    assert correct.compare_train(rec["check"], ref32)["loss_gap"] < 0.01
