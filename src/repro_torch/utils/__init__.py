"""Shared helpers of the port."""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none —
    the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def disable_tf32() -> None:
    """f32 where the reference says f32: on the card, f32 matmuls and
    cuDNN's f32 convolutions would otherwise be allowed TF32 (cuDNN's
    default), which keeps about three decimal digits.  Process-wide, as
    PyTorch's flags are; every entry point of the port calls it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_FMA_CHUNK = 1 << 24        # elements per pass: bounds the f64 temporaries


def fma_f32(m, u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """m·u + g rounded once to f32, as one fused multiply-add, on any
    device; ``m`` is a number (taken as f32) or an f32 tensor that
    broadcasts with u and g.  This is what the reference computes under
    ``jit``, where XLA contracts a product feeding a sum into an FMA (its
    Pallas kernels in interpret mode too): the EF momentum ``m*u + g``,
    the AE's SGD update, the int8 wire's dequantize-and-add.

    The product of two f32 values is exact in f64; the sum is rounded to
    f64 toward odd (TwoSum gives its exact error), and rounding that to
    f32 is then the one correct rounding (53 >= 2·24 + 2 bits).  A plain
    f64 sum cast to f32 rounds twice and is wrong in rare cases;
    ``m * u + g`` in f32 rounds the product and the sum apart.  Inf and
    NaN pass through as the f32 FMA gives them.  Runs in chunks so its
    f64 temporaries stay bounded at any length."""
    scalar = not isinstance(m, torch.Tensor)
    if scalar:
        m = float(torch.tensor(m, dtype=torch.float32))
        u, g = torch.broadcast_tensors(u, g)
    else:
        m, u, g = torch.broadcast_tensors(m, u, g)
        mf = m.reshape(-1)
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    uf, gf, of = u.reshape(-1), g.reshape(-1), out.view(-1)
    for s in range(0, of.numel(), _FMA_CHUNK):
        sl = slice(s, s + _FMA_CHUNK)
        a = uf[sl].double()
        a.mul_(m if scalar else mf[sl].double())          # exact
        b = gf[sl].double()
        t = a + b
        e = t - a                                         # TwoSum error:
        a.sub_(t - e)                                     # (a - (t - bb))
        b.sub_(e)                                         # + (b - bb)
        e = a.add_(b)
        inexact = (e != 0) & e.isfinite()
        bits = t.view(torch.int64)
        bits.sub_((inexact & ((e < 0) != (t < 0))).long())  # toward zero
        bits.bitwise_or_(inexact.long())                  # round to odd
        of[sl] = t
    return out
