"""Share of its roofline that the Schur phase reaches: the least time the
card could take for its operations or bytes (portbench/roofline.py,
counted from shapes) over the device time of DenseLMICone.schur at the
window's final iterate and batch (CUDA events), whatever implements it.
Nothing to read off a card the peak table does not hold."""

from portbench import roofline
from portbench.measure import cuda_ms


def read(ctx):
    from conex_tpu_torch import DenseLMICone

    f = ctx.final
    lmis = [(blk, w) for blk, w in zip(f.blocks, f.ws) if isinstance(blk, DenseLMICone)]
    if not lmis or ctx.device.type != "cuda":
        return None
    least = spent = 0.0
    for blk, w in lmis:
        S, B, m, n, _ = blk.A.shape
        bound = roofline.bound_s(roofline.schur_ops(S * B, m, n),
                                 roofline.schur_bytes(S * B, S, m, n, blk.A.element_size()),
                                 ctx.kind, ctx.dtype)
        if bound is None:
            return None
        ms = cuda_ms(lambda: blk.schur(w), ctx.device)
        ctx.note(f"schur at {(S, B, m, n)} {ctx.dtype}: {ms!r} ms, bound "
                 f"{bound[0] * 1e3!r} ms by {bound[1]}")
        least += bound[0]
        spent += ms * 1e-3
    return 100.0 * least / spent
