"""DynamicStepRouter: the PyTorch counterpart of tpu_asr/kd/router.py
(reference asr_train.py:1021-1218), the per-sample ODE step-count policy of
FM-KT.

For every layer l and sample b: reduce the student and teacher features over
time ('gap'/'mean': the mean over all T frames, padding included; 'last':
the final frame), project each (Linear + ReLU), concatenate with the layer-id
embedding, and map through fc1 + ReLU + fc2 to K = max_steps logits (fp32),
the first `min_steps - 1` masked to -inf. Training draws a Gumbel sample
from the `gumbel` generator and takes steps = argmax(softmax((logits + g) /
temperature)) + 1; eval takes argmax(probs) + 1.

One call takes all L layers, (L, B, T, C) features and layer ids 0..L-1,
and draws the (L, B, K) Gumbel noise at once, as JAX's nn.vmap with
split_rngs={'gumbel': True} gives each layer a draw of its own. The router
loss is summed over layers; per layer it is
  budget_weight * (mean_b steps - budget_target)^2
  - entropy_weight * mean_b H(probs).

Reference quirks kept: the budget term is built from the integer steps and
carries no gradient (the entropy term is the router's only gradient); the
straight-through one-hot is not built.

Parameters carry the JAX module's names: `stu_proj`, `tch_proj`,
`layer_emb`, `router_fc1`, `router_fc2`. Products run in the compute dtype
(JAX's nn.Dense(dtype=...)), the logits in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.config import RouterConfig
from tpu_asr_torch.kd.meta_encoders import dense

STRATEGIES = ("batch_mode", "batch_avg", "batch_median", "group")


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """-log(-log(u)), u uniform on [1e-20, 1) (JAX's uniform(minval=1e-20,
    maxval=1.0)), fp32."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-20)))


class DynamicStepRouter(nn.Module):
    def __init__(self, cfg: RouterConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.feature_reduce not in ("gap", "mean", "last"):
            raise ValueError(f"unknown feature_reduce: {cfg.feature_reduce}")
        self.cfg, self.dtype = cfg, dtype
        c = cfg
        self.stu_proj = nn.Linear(c.stu_dim, c.proj_dim)
        self.tch_proj = nn.Linear(c.tch_dim, c.proj_dim)
        width = 2 * c.proj_dim
        if c.use_layer_id:
            self.layer_emb = nn.Embedding(c.num_layers, c.layer_emb_dim)
            width += c.layer_emb_dim
        self.router_fc1 = nn.Linear(width, c.hidden_dim)
        self.router_fc2 = nn.Linear(c.hidden_dim, c.max_steps)

    def hidden(self, stu_feat: torch.Tensor, tch_feat: torch.Tensor,
               layer_ids: torch.Tensor) -> torch.Tensor:
        """(L, B, hidden_dim) activations that router_fc2 reads, from
        (L, B, T, C) features and (L,) layer ids."""
        c, dt = self.cfg, self.dtype
        if c.feature_reduce == "last":
            stu_vec, tch_vec = stu_feat[:, :, -1], tch_feat[:, :, -1]
        else:
            stu_vec, tch_vec = stu_feat.mean(dim=2), tch_feat.mean(dim=2)
        parts = [F.relu(dense(self.stu_proj, stu_vec.to(dt))),
                 F.relu(dense(self.tch_proj, tch_vec.to(dt)))]
        if c.use_layer_id:
            emb = self.layer_emb.weight.to(dt)[layer_ids.long()]   # (L, E)
            parts.append(emb[:, None].expand(-1, stu_vec.shape[1], -1))
        return F.relu(dense(self.router_fc1, torch.cat(parts, dim=-1)))

    def logits(self, stu_feat: torch.Tensor, tch_feat: torch.Tensor,
               layer_ids: torch.Tensor) -> torch.Tensor:
        """(L, B, K) fp32 logits, min_steps mask applied."""
        c = self.cfg
        h = self.hidden(stu_feat, tch_feat, layer_ids)
        logits = dense(self.router_fc2, h).float()
        if c.min_steps > 1:
            mask = torch.zeros(c.max_steps, device=logits.device)
            mask[:c.min_steps - 1] = float("-inf")
            logits = logits + mask
        return logits

    def forward(self, stu_feat: torch.Tensor, tch_feat: torch.Tensor,
                layer_ids: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
        """(steps (L, B) int32, router loss summed over layers, {'logits',
        'probs' (L, B, K), 'expected_steps' (L, B)}). Training needs the
        `gumbel` generator, on the features' device."""
        c = self.cfg
        k = c.max_steps
        logits = self.logits(stu_feat, tch_feat, layer_ids)
        probs = torch.softmax(logits, dim=-1)
        ks = torch.arange(1, k + 1, dtype=torch.float32, device=probs.device)
        expected = (probs * ks).sum(dim=-1)
        loss = torch.zeros((), device=logits.device)
        if train:
            if generator is None:
                raise ValueError("DynamicStepRouter: training needs the "
                                 "'gumbel' generator")
            g = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits + g) / c.temperature, dim=-1)
            steps = y_soft.argmax(dim=-1).to(torch.int32) + 1
            if c.budget_target is not None and c.budget_weight > 0:
                mean = steps.float().mean(dim=1)                 # (L,)
                loss = loss + c.budget_weight * torch.square(
                    mean - c.budget_target).sum()
            if c.entropy_weight > 0:
                ent = -(probs * torch.log(probs.clamp(min=1e-8))).sum(-1)
                loss = loss - c.entropy_weight * ent.mean(dim=1).sum()
        else:
            steps = probs.argmax(dim=-1).to(torch.int32) + 1
        return steps, loss, {"logits": logits, "probs": probs,
                             "expected_steps": expected}


def aggregate_steps(steps: torch.Tensor, strategy: str,
                    max_steps: int) -> torch.Tensor:
    """One int32 step count per row of `steps` (..., B) by the batch
    strategy (reference asr_train.py:610-637): 'batch_mode' the most
    frequent count, the smallest among ties (torch.mode's rule, JAX's first
    argmax); 'batch_avg' the mean rounded half to even; 'batch_median' the
    lower middle element; the last two clipped to 1..max_steps. 'group'
    keeps per-sample counts and is the caller's (raises here)."""
    if strategy == "batch_mode":
        counts = F.one_hot(steps.long() - 1, max_steps).sum(dim=-2)
        return (counts.argmax(dim=-1) + 1).to(torch.int32)
    if strategy == "batch_avg":
        avg = torch.round(steps.float().mean(dim=-1))
    elif strategy == "batch_median":
        srt = torch.sort(steps, dim=-1).values
        avg = srt[..., (steps.shape[-1] - 1) // 2].float()
    else:
        raise ValueError(f"Unknown router strategy: {strategy}")
    return avg.clamp(1, max_steps).to(torch.int32)
