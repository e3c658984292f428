"""Learned and affine dynamics models (counterpart of
mpc_tpu/models/dynamics.py:21-363, reference mpc/dynamics.py).

Every model is an ``nn.Module`` callable as ``model(x, u) -> x_next`` on
the last axis of batched inputs x [..., n_state], u [..., n_ctrl], as the
port's other models are.  Products are elementwise multiplications summed
over the last axis (``ops/linalg.py``), never ``matmul``: a float32 model
gives the same bits on the card whether or not TF32 is allowed.

``NNDynamics`` also carries the structure-of-arrays stream form that
kernel K3 runs for a one-hidden-layer MLP (csrc/nn.cuh, the counterpart
of the JAX package's param-streaming ``_stream_core``,
mpc_tpu/models/dynamics.py:176-235): the flat weight vector of
``kernel_params`` and the plain PyTorch step and Jacobian on component
tensors, which ``ops/fused.py:fused_solve_long_plain`` runs; and, at any
depth, ``soa_step`` (mpc_tpu/models/dynamics.py:285-309) with the
hand-written ``soa_jacobian``, the step and Jacobian of the dense
configuration's MLP build (csrc/nn_dense.cuh), which
``ops/fused_dense.py:fused_solve_dense_plain`` runs.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import linalg
from ..utils.device import resolve_device

ACTS = {
    'sigmoid': torch.sigmoid,
    'relu': torch.relu,
    'elu': nn.functional.elu,
}

# derivative of the activation in terms of its OUTPUT z (the reference
# reconstructs Jacobians from stored activations, mpc/dynamics.py:98-112)
_ACT_DERIV_FROM_OUT = {
    'sigmoid': lambda z: z * (1.0 - z),
    'relu': lambda z: (z > 0).to(z.dtype),
    'elu': lambda z: torch.where(z > 0, torch.ones_like(z), z + 1.0),
}

# the forms the kernel computes (mpc_tpu/models/dynamics.py:36-55):
# sigmoid through tanh, which stays finite when saturated where
# 1 / (1 + exp(-v)) overflows exp for v < ~-88 in float32
_ACTS_SOA = {
    'sigmoid': lambda v: 0.5 * (torch.tanh(0.5 * v) + 1.0),
    'relu': lambda v: torch.clamp(v, min=0.0),
    'elu': lambda v: torch.where(v > 0, v, torch.exp(v) - 1.0),
}

# their derivatives from the PRE-activation v
_ACT_DERIV_SOA = {
    'sigmoid': lambda v: (lambda s: s * (1.0 - s))(
        0.5 * (torch.tanh(0.5 * v) + 1.0)),
    'relu': lambda v: (v > 0).to(v.dtype),
    'elu': lambda v: torch.where(v > 0, torch.ones_like(v), torch.exp(v)),
}


class NNDynamics(nn.Module):
    """MLP dynamics with an analytic input-Jacobian (reference
    NNDynamics, mpc/dynamics.py:15-130).

    ``layers`` are ``nn.Linear`` with W [n_out, n_in] (the JAX package's
    layout); the last has no activation, and ``passthrough`` adds x to
    the output (reference mpc/dynamics.py:73-74)."""

    def __init__(self, layers: Sequence[nn.Linear], activation='sigmoid',
                 passthrough=True):
        super().__init__()
        if activation not in ACTS:
            raise ValueError(f'activation must be one of {sorted(ACTS)}')
        self.layers = nn.ModuleList(layers)
        self.activation = activation
        self.passthrough = passthrough
        self.n_state = self.layers[-1].out_features
        self.n_ctrl = self.layers[0].in_features - self.n_state

    @staticmethod
    def init(n_state, n_ctrl, hidden_sizes=(100,), activation='sigmoid',
             passthrough=True, *, generator: torch.Generator, device=None,
             dtype=torch.float32) -> 'NNDynamics':
        """torch.nn.Linear's default init, uniform(-1/sqrt(fan_in),
        1/sqrt(fan_in)) for W and then b of each layer in order
        (mpc_tpu/models/dynamics.py:74-87), drawn from ``generator``, a
        CPU generator, so that the weights do not depend on the
        device."""
        sizes = [n_state + n_ctrl] + list(hidden_sizes) + [n_state]
        device = resolve_device(device)
        layers = []
        for n_in, n_out in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / n_in ** 0.5
            lin = nn.utils.skip_init(nn.Linear, n_in, n_out, device=device,
                                     dtype=dtype)
            with torch.no_grad():
                for p in (lin.weight, lin.bias):
                    p.copy_(torch.empty(p.shape, dtype=dtype).uniform_(
                        -bound, bound, generator=generator))
            layers.append(lin)
        return NNDynamics(layers, activation, passthrough)

    def _forward_with_acts(self, x, u):
        z = torch.cat([x, u], -1)
        act = ACTS[self.activation]
        zs = []
        for i, lin in enumerate(self.layers):
            z = linalg.bmv(lin.weight, z) + lin.bias
            if i < len(self.layers) - 1:
                z = act(z)
                zs.append(z)
        if self.passthrough:
            z = z + x
        return z, zs

    def forward(self, x, u):
        return self._forward_with_acts(x, u)[0]

    def grad_input(self, x, u):
        """Analytic Jacobian (R [..., n_state, n_state], S [..., n_state,
        n_ctrl]) from the stored activations: the reverse product of the
        layer weights with the activation-derivative masks (reference
        mpc/dynamics.py:81-130), batched on the leading axes."""
        _, zs = self._forward_with_acts(x, u)
        deriv = _ACT_DERIV_FROM_OUT[self.activation]
        grad = self.layers[-1].weight                 # [n_state, n_hidden]
        for i in range(len(zs) - 1, -1, -1):
            grad = linalg.bmm(grad, self.layers[i].weight
                              * deriv(zs[i]).unsqueeze(-1))
        R = grad[..., :self.n_state]
        S = grad[..., self.n_state:]
        if self.passthrough:
            R = R + torch.eye(self.n_state, dtype=R.dtype, device=R.device)
        return R, S

    # -- the stream form of kernel K3 (csrc/nn.cuh) ----------------------
    @property
    def streams(self) -> bool:
        """Whether K3's stream form covers the model: one hidden layer
        (mpc_tpu/models/dynamics.py:170-174)."""
        return len(self.layers) == 2

    @property
    def hidden(self) -> int:
        """The width of the first hidden layer."""
        return self.layers[0].out_features

    def soa_param_count(self) -> int:
        return sum(lin.weight.numel() + lin.bias.numel()
                   for lin in self.layers)

    @property
    def sizes(self) -> tuple:
        """The layer widths (n_in, hidden..., n_state)."""
        return (self.layers[0].in_features,) + tuple(
            lin.out_features for lin in self.layers)

    @staticmethod
    def shaped(sizes, activation='sigmoid', passthrough=True):
        """An MLP of the layer widths ``sizes`` with no weights (its
        layers on the meta device): what ``soa_step`` and
        ``soa_jacobian`` need besides the flat weights they are given."""
        return NNDynamics([nn.Linear(a, b, device='meta')
                           for a, b in zip(sizes[:-1], sizes[1:])],
                          activation, passthrough)

    def kernel_params(self):
        """The flat weight vector in mpc_tpu's ``soa_params_flat`` order
        (mpc_tpu/models/dynamics.py:151-158): each layer's W row-major,
        then its b."""
        return torch.cat([torch.cat([lin.weight.reshape(-1), lin.bias])
                          for lin in self.layers])

    def _stream_weights(self, w):
        """(W1 [H, n_in], b1 [H], W2 [n_state, H], b2 [n_state]) from the
        flat vector ``w`` of a one-hidden-layer MLP."""
        n_in = self.n_state + self.n_ctrl
        H = self.hidden
        W1 = w[:H * n_in].view(H, n_in)
        b1 = w[H * n_in:H * (n_in + 1)]
        w2_off = H * (n_in + 1)
        W2 = w[w2_off:w2_off + self.n_state * H].view(self.n_state, H)
        return W1, b1, W2, w[w2_off + self.n_state * H:]

    def _stream_pre(self, comps, W1, b1):
        """The pre-activations v [..., H] of every hidden unit k in the
        kernel's order: w1[k, 0] z_0 + w1[k, 1] z_1 + ... + b1[k]."""
        v = W1[:, 0] * comps[0].unsqueeze(-1)
        for i in range(1, len(comps)):
            v = v + W1[:, i] * comps[i].unsqueeze(-1)
        return v + b1

    def soa_stream_step(self, xs, u, w):
        """The step K3 computes, on component tensors xs = (x_0, x_1,
        ...) and u of one shape (one control), with the
        flat weights ``w``: each output accumulates w2[j, k] h_k over the
        hidden units k in order from exact zero, then adds b2[j] and,
        with passthrough, x_j (mpc_tpu/models/dynamics.py:215-229).  The
        hidden units' own arithmetic is elementwise, so it runs for all
        k at once."""
        comps = list(xs) + [u]
        W1, b1, W2, b2 = self._stream_weights(w)
        h = _ACTS_SOA[self.activation](self._stream_pre(comps, W1, b1))
        terms = (W2 * h.unsqueeze(-2)).unbind(-1)     # [..., n_state] each
        acc = torch.zeros_like(terms[0])
        for term in terms:
            acc = acc + term
        out = acc + b2
        if self.passthrough:
            out = out + torch.stack(comps[:self.n_state], -1)
        return tuple(out.unbind(-1))

    def soa_stream_jac(self, xs, u, w):
        """The step's Jacobian K3 computes, as rows of component tensors
        J[j][i] = d x'_j / d (x, u)_i: (w2[j, k] act'(v_k)) w1[k, i]
        accumulated over k in order from exact zero, then 1 on the
        diagonal with passthrough (mpc_tpu/models/dynamics.py:205-227)."""
        comps = list(xs) + [u]
        W1, b1, W2, _ = self._stream_weights(w)
        d = _ACT_DERIV_SOA[self.activation](self._stream_pre(comps, W1, b1))
        wd = W2 * d.unsqueeze(-2)                     # [..., n_state, H]
        terms = (wd.unsqueeze(-2) * W1.t()).unbind(-1)
        J = torch.zeros_like(terms[0])                # [..., n_state, n_in]
        for term in terms:
            J = J + term
        rows = [list(J[..., j, :].unbind(-1)) for j in range(self.n_state)]
        if self.passthrough:
            for j in range(self.n_state):
                rows[j][j] = rows[j][j] + 1.0
        return rows

    # -- the step of the dense kernel's MLP build (csrc/nn_dense.cuh) ------
    def _flat_layers(self, w):
        """[(W [n_out, n_in], b [n_out])] of each layer, views of the flat
        vector ``w`` (``kernel_params`` order, or a sequence of its
        scalars)."""
        if not torch.is_tensor(w):
            w = torch.stack(list(w))
        out, off = [], 0
        for n_in, n_out in zip(self.sizes[:-1], self.sizes[1:]):
            W = w[off:off + n_out * n_in].view(n_out, n_in)
            off += n_out * n_in
            out.append((W, w[off:off + n_out]))
            off += n_out
        return out

    def _soa_inputs(self, xs, u):
        """The components (x..., u...) stacked on a last axis; ``u`` a
        component or a tuple of them."""
        us = list(u) if isinstance(u, (tuple, list)) else [u]
        return torch.stack(list(xs) + us, -1)

    def soa_step(self, xs, u, params):
        """mpc_tpu's ``soa_step`` at any depth
        (mpc_tpu/models/dynamics.py:285-309) on component tensors xs =
        (x_0, x_1, ...) and u (a component, or a tuple of them for several
        controls) with the flat weights ``params``: each unit's
        pre-activation a dot product over the layer's inputs from the first
        term on, then its bias (``_pre``), the activation in the form that
        stays finite when saturated, the passthrough last.  The dense
        kernel's MLP build computes the same in the same order, a unit a
        lane (csrc/nn_dense.cuh)."""
        z0 = self._soa_inputs(xs, u)
        layers = self._flat_layers(params)
        act = _ACTS_SOA[self.activation]
        z = z0
        for i, (W, b) in enumerate(layers):
            z = _pre(z, W, b)
            if i < len(layers) - 1:
                z = act(z)
        if self.passthrough:
            z = z + z0[..., :self.n_state]
        return tuple(z.unbind(-1))

    def soa_jacobian(self, xs, u, params):
        """d x_{t+1} / d (x_t, u_t) as rows of component tensors,
        J[j][i], written by hand as the reverse product of the layers with
        the activations' derivatives (the reference's ``grad_input``,
        mpc/dynamics.py:81-130) in the dense kernel's order: the hidden
        pre-activations v as ``soa_step`` forms them, then G = W_L and,
        layer by layer down, G[j, m] <- sum_k (G[j, k] act'(v_k)) W[k, m],
        k ascending from the first term (the stream form's order,
        ``soa_stream_jac``, at one hidden layer); 1 on the diagonal with
        the passthrough."""
        z = self._soa_inputs(xs, u)
        layers = self._flat_layers(params)
        act = _ACTS_SOA[self.activation]
        dact = _ACT_DERIV_SOA[self.activation]
        ds = []
        for W, b in layers[:-1]:
            v = _pre(z, W, b)
            ds.append(dact(v))
            z = act(v)
        G = layers[-1][0]
        for (W, _), d in zip(reversed(layers[:-1]), reversed(ds)):
            gd = G * d.unsqueeze(-2)                  # [..., n_state, h]
            acc = gd[..., 0:1] * W[0]
            for k in range(1, W.shape[0]):
                acc = acc + gd[..., k:k + 1] * W[k]
            G = acc
        rows = [list(G[..., j, :].unbind(-1)) for j in range(self.n_state)]
        if self.passthrough:
            for j in range(self.n_state):
                rows[j][j] = rows[j][j] + 1.0
        return rows


def _pre(z, W, b):
    """A layer's pre-activations [..., n_out] from its inputs z
    [..., n_in]: W[k, 0] z_0 + W[k, 1] z_1 + ... + b[k], from the first
    term on."""
    v = W[:, 0] * z[..., 0:1]
    for i in range(1, W.shape[1]):
        v = v + W[:, i] * z[..., i:i + 1]
    return v + b


class AffineDynamics(nn.Module):
    """x' = A x + B u + c (reference AffineDynamics,
    mpc/dynamics.py:159-202).  A [n_state, n_state], B [n_state, n_ctrl]
    and c [n_state] or None are buffers: tensors that require grad get
    gradients through the solve."""

    def __init__(self, A, B, c=None):
        super().__init__()
        self.register_buffer('A', torch.as_tensor(A))
        self.register_buffer('B', torch.as_tensor(B))
        self.register_buffer('c', None if c is None else torch.as_tensor(c))

    def forward(self, x, u):
        z = linalg.bmv(self.A, x) + linalg.bmv(self.B, u)
        if self.c is not None:
            z = z + self.c
        return z

    def grad_input(self, x, u):
        lead = x.shape[:-1]
        return (self.A.expand(lead + self.A.shape),
                self.B.expand(lead + self.B.shape))


class CtrlPassthroughDynamics(nn.Module):
    """Wraps a model to act on the slew-augmented state (u_{t-1}, x)
    (reference CtrlPassthroughDynamics, mpc/dynamics.py:133-156)."""

    def __init__(self, dynamics):
        super().__init__()
        self.dynamics = dynamics

    def forward(self, tilde_x, u):
        n_ctrl = u.shape[-1]
        return torch.cat([u, self.dynamics(tilde_x[..., n_ctrl:], u)], -1)
