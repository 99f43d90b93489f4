"""NEGATIVE fixture: shard-spec, the psum mirror.

The decoder's per-layer trio holds 2 branch-collapsed psum sites (the
attention out and one FFN arm of two), the embedding 1 psum and the
logits 1 all_gather: 2L + 2. The server's mirror claims the same.
Expected: 0 findings.
"""

from defer_tpu_torch.parallel.collectives import all_gather, psum


def embed_lookup(table, ids, tp):
    return psum(table[ids], tp)


class GptDecoder:
    def _attn_qkv(self, p, x):
        return x, x, x

    def _attn_out(self, p, x, attn, tp):
        x = x + psum(attn, tp)
        if p["swiglu"]:
            return x + psum(x, tp)
        return x + psum(x * 2, tp)

    def _block(self, p, x, tp):
        q, k, v = self._attn_qkv(p, x)
        return self._attn_out(p, x, q, tp)

    def _final_logits(self, params, x, tp):
        logits = x
        if tp is None:
            return logits
        return all_gather(logits, tp, dim=-1)


class Server:
    def __init__(self, dec, mesh):
        self._psums_per_fwd = (2 * dec.cfg.num_layers + 2
                               if mesh is not None else 0)
