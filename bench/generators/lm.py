"""The language-model cells' inputs, drawn from the seed: the float
parameters of the configuration, leaf by leaf on the device, and each
client's requests (prompt tokens, prompt and output lengths).

The parameter tree has the layout ``repro_torch.models.lm`` serves (the
stack's layers under ``stack/b<i>`` with a leading period axis, the
dense prologue layers in a list), with the scales of the port's own
initialiser: normal over ``sqrt(fan_in)``, the router at 0.02, the
embeddings at 0.02, norms at one.  Both the program and the plain
reference take these floats; each leaf has a generator of its own,
seeded from ``(seed, leaf index)``, so the reference can draw one leaf
again without the others.  Request sizes come from a fixed cycle of
sizes dealt to the clients by the seed: every seed offers the same work
in another order.  Nothing here imports the program.
"""
from __future__ import annotations

import math

from bench.generators.cnn import derive

__all__ = ["derive", "widths", "leaf_specs", "draw_leaf", "draw_params",
           "Requests"]


def widths(c: dict) -> dict:
    """The sizes the model's layers are made of, from the catalog keys."""
    h = c["num_attention_heads"]
    return {"d": c["hidden_size"], "h": h, "dn": c["qk_nope_head_dim"],
            "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "qr": c["q_lora_rank"], "kr": c["kv_lora_rank"],
            "e": c["n_routed_experts"], "f": c["moe_intermediate_size"],
            "fs": c["moe_intermediate_size"] * c["n_shared_experts"],
            "dff": c["intermediate_size"], "v": c["vocab_size"],
            "k": c["num_experts_per_tok"],
            "n_dense": c["first_k_dense_replace"],
            "n_stack": c["num_hidden_layers"] - c["first_k_dense_replace"]}


def _mla(w: dict, lead: tuple) -> list:
    d, h, dn, dr, dv = w["d"], w["h"], w["dn"], w["dr"], w["dv"]
    return [(("q_a_proj",), lead + (d, w["qr"]), d),
            (("q_a_norm", "w"), lead + (w["qr"],), None),
            (("q_b_proj",), lead + (w["qr"], h * (dn + dr)), w["qr"]),
            (("kv_a_proj",), lead + (d, w["kr"] + dr), d),
            (("kv_a_norm", "w"), lead + (w["kr"],), None),
            (("kv_b_proj",), lead + (w["kr"], h * (dn + dv)), w["kr"]),
            (("o_proj",), lead + (h * dv, d), h * dv)]


def _swiglu(d: int, ff: int, lead: tuple) -> list:
    return [(("up_proj",), lead + (d, ff), d),
            (("gate_proj",), lead + (d, ff), d),
            (("down_proj",), lead + (ff, d), ff)]


def leaf_specs(c: dict) -> list:
    """``[(path, shape, init)]`` for every leaf, in a fixed order: init is
    the fan-in of a normal leaf (scale ``1/sqrt(fan_in)``), a float scale
    (the router, the embeddings), or ``None`` for a norm's ones."""
    w = widths(c)
    d, lead = w["d"], (w["n_stack"],)
    out = [(("embed",), (w["v"], d), 0.02),
           (("final_norm", "w"), (d,), None),
           (("out_embed",), (w["v"], d), 0.02)]

    def layer(prefix, lead, moe):
        rows = [(("norm1", "w"), lead + (d,), None)]
        rows += [(("mixer",) + p, s, i) for p, s, i in _mla(w, lead)]
        rows.append((("norm2", "w"), lead + (d,), None))
        if moe:
            e, f = w["e"], w["f"]
            rows += [(("mlp", "router"), lead + (d, e), 0.02),
                     (("mlp", "w_experts_gate"), lead + (e, d, f), d),
                     (("mlp", "w_experts_in"), lead + (e, d, f), d),
                     (("mlp", "w_experts_out"), lead + (e, f, d), f)]
            rows += [(("mlp", "shared") + p, s, i)
                     for p, s, i in _swiglu(d, w["fs"], lead)]
        else:
            rows += [(("mlp",) + p, s, i)
                     for p, s, i in _swiglu(d, w["dff"], lead)]
        return [(prefix + p, s, i) for p, s, i in rows]

    out += layer(("stack", "b0"), lead, True)
    for j in range(w["n_dense"]):
        out += layer(("prologue", j), (), False)
    return out


def draw_leaf(spec, seed: int, index: int, device):
    """Leaf ``index`` of :func:`leaf_specs` as float32 on ``device``."""
    import torch
    _, shape, init = spec
    if init is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(derive(seed, 20, index))
    scale = init if isinstance(init, float) else 1.0 / math.sqrt(init)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32).mul_(scale)


def draw_params(c: dict, seed: int, device) -> dict:
    """The whole parameter tree."""
    tree: dict = {}
    for i, spec in enumerate(leaf_specs(c)):
        node = tree
        path = spec[0]
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = draw_leaf(spec, seed, i, device)
    return tree


# the golden ratio's fraction: spreads a run of positions evenly over [0, 1)
_PHI = 0.6180339887498949


class Requests:
    """Client ``c``'s ``j``-th request, from the seed.

    The traffic's ``cycle`` sizes: position ``i`` has a prompt length
    evenly spaced over the prompt range and an output length spread over
    the output range by a fixed scramble of ``i``.  Every seed offers the
    same sizes in another order: the seed deals the positions to the
    clients, and a client's ``j``-th request takes the position ``j``
    after its own; the driver submits the first population in the order
    of its positions.  Its first request (``j == 0``, the population that
    fills the pool before the window) asks for a fixed fraction of its
    output length, spread over (0, 1] by position, so that completions
    are staggered from the start.  Prompt tokens are uniform over the
    vocabulary."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        import numpy as np
        self.traffic, self.vocab, self.seed = traffic, vocab, seed
        n = int(traffic["cycle"])
        p_lo, p_hi = traffic["prompt_len"]
        o_lo, o_hi = traffic["output_len"]
        i = np.arange(n)
        prompts = p_lo + np.floor((i + 0.5) / n * (p_hi - p_lo + 1))
        outs = o_lo + np.floor(((i + 0.5) * _PHI) % 1.0
                               * (o_hi - o_lo + 1))
        first = np.ceil(((i + 0.5) * _PHI * _PHI) % 1.0 * outs)
        self.sizes = [(int(a), int(b), max(1, int(c)))
                      for a, b, c in zip(prompts, outs, first)]
        rng = np.random.default_rng(derive(seed, 10))
        self.start = rng.permutation(n).tolist()
        self.clients = int(traffic["clients"])

    @property
    def max_len(self) -> int:
        return int(self.traffic["prompt_len"][1]
                   + self.traffic["output_len"][1])

    def position(self, client: int, j: int = 0) -> int:
        """The position in the cycle of client ``client``'s ``j``-th
        request."""
        n = len(self.sizes)
        return (self.start[client % n] + client // n + j) % n

    def get(self, client: int, j: int):
        """``(prompt tokens int32 array, max_new_tokens)``."""
        import numpy as np
        p_len, o_len, first = self.sizes[self.position(client, j)]
        rng = np.random.default_rng(derive(self.seed, 11, client, j))
        tokens = rng.integers(0, self.vocab, size=p_len, dtype=np.int64)
        return tokens.astype(np.int32), first if j == 0 else o_len
