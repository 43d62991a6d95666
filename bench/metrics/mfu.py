"""mfu: model FLOPs of the real tokens the model calls inside the window
processed, over the window and the H100's bf16 peak, in percent.

Prefill counts each row's real prompt tokens, their attention over the
real positions before them and the head at each row's last position;
decode step s of a wave counts the rows that still need its token (s + 1
below the request's output length), their attention and their head.
Pads, a wave's finished rows and its last step are not counted."""
from bench import yardstick as Y
from bench.weights import group_count, group_pattern


def read(run):
    port = run.port
    pattern, groups = group_pattern(port), group_count(port)
    tokens = pairs = heads = 0
    step = {}
    for c in run.calls:
        s = step.get(c.wave, -1)
        step[c.wave] = s + 1
        if not (c.t0 >= run.t0 and c.t1 <= run.t_end):
            continue
        reqs = [run.requests[rid] for rid in run.waves[c.wave].rids]
        if c.kind == "prefill":
            for r in reqs:
                n = len(r.prompt)
                tokens += n
                pairs += Y.causal_pairs(n)
                heads += 1
        else:
            for r in reqs:
                if s + 1 < r.max_new:
                    pos = len(r.prompt) + s
                    tokens += 1
                    pairs += pos + 1
                    heads += 1
    if not tokens:
        return None
    flops = Y.model_flops(port, pattern, groups, tokens=tokens,
                          live_keys=pairs, head_rows=heads)
    return flops / run.seconds / Y.BF16_FLOP_PER_S * 100
