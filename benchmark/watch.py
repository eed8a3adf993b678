"""Reading the program's first train steps from outside it.

``FirstSteps`` hangs a post-step hook on the program's optimizer (the
public ``register_step_post_hook`` of ``torch.optim``) for the first
``after`` steps: after step 1 it reads each leaf's first gradient from
Adam's state (``exp_avg / (1 - b1)``, the gradient as the optimizer got
it), after step ``after`` each leaf's change from the weights the
benchmark gave it; then it removes itself.  Until step 1 is done it also
wraps ``torch.Tensor.backward`` to read the first step's loss, the scalar
the program's train step differentiates, and a forward hook on each of
the modules named in ``outputs`` keeps the first output it gives (on the
host).  Only these are kept.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


class FirstSteps:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 initial: Dict[str, torch.Tensor], after: int = 3, outputs: Sequence[str] = ()):
        self.params = dict(model.named_parameters())
        self.initial = initial
        self.after = after
        self.steps = 0
        self.grad_norms: Optional[Dict[str, float]] = None
        self.change_norms: Optional[Dict[str, float]] = None
        self.first_loss: Optional[float] = None
        self._backward = real = torch.Tensor.backward

        def backward(tensor, *args, **kwargs):
            if self.first_loss is None and tensor.dim() == 0:
                self.first_loss = float(tensor.detach())
            return real(tensor, *args, **kwargs)

        torch.Tensor.backward = backward
        from mfvae_tpu_torch.training import trainer

        self.huber_calls: list = []  # (x, y, delta, value) of step 1's loss reductions
        self._trainer = trainer
        self._huber = real_huber = trainer.huber_mean

        def huber_mean(x, y, delta=1.0):
            out = real_huber(x, y, delta)
            self.huber_calls.append((x.detach().float().cpu(), y.detach().float().cpu(), float(delta),
                                     float(out.detach())))
            return out

        trainer.huber_mean = huber_mean
        self._handle = optimizer.register_step_post_hook(self._hook)
        self.first_outputs: Dict[str, torch.Tensor] = {}
        modules = dict(model.named_modules())
        self._out_handles = [modules[name].register_forward_hook(self._keeper(name)) for name in outputs]

    def _keeper(self, name: str):
        def keep(module, args, output):
            if name not in self.first_outputs:
                self.first_outputs[name] = output.detach().float().cpu()
        return keep

    def close(self) -> None:
        """Puts ``torch.Tensor.backward`` and ``trainer.huber_mean`` back
        and removes the forward hooks (also done after step 1)."""
        torch.Tensor.backward = self._backward
        self._trainer.huber_mean = self._huber
        for handle in self._out_handles:
            handle.remove()
        self._out_handles = []

    def _hook(self, optimizer, args, kwargs):
        self.steps += 1
        if self.steps == 1:
            self.close()
            b1 = optimizer.param_groups[0]["betas"][0]
            self.grad_norms = {n: _norm(optimizer.state[p]["exp_avg"]) / (1.0 - b1) if p in optimizer.state else 0.0
                               for n, p in self.params.items()}
        if self.steps == self.after:
            self.change_norms = {n: _norm(p.detach() - self.initial[n]) for n, p in self.params.items()}
            self._handle.remove()
            self.initial = None
