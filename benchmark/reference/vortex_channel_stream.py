"""Plain reference of `vortex_channel_stream`: one Picard iteration of the
random-basis space-time solver of the vortex channel scene
(`scripts/vortex_channel.sh`, the channel preset of `starterL.py`), for
the incompressible flow of Chen et al.'s INSR benchmark scene (arXiv
2210.00124) on [-1, 1]^2 x [0, 1].

The field. Sites: the cell centres of a res x res grid (res^2 =
n_spatial_basis) at each of T slice times linspace(0, 1, T). Each site n
carries, for each variable e (the stream function psi, the pressure p) and
each of J features, a fixed random direction A (2,), time direction tA
and bias b, and a coefficient u. A variable at (x, t) is

    f_e(x, t) = sum_k w_k(x) sigma(A.(x - c_k)/bw + tA (t - s_k)/tbw + b) u_k

over the K spatially nearest sites k of the point's own slice (one-slice
windows, bw = 1, tbw the slice spacing), with the C1 partition of unity
w_k = S(1 - |dx|/h) S(1 - |dy|/h), S(a) = 3a^2 - 2a^3, h the site spacing,
Shepard-normalised (w_k / sum_j w_j) and differentiated by the quotient
rule; the time weight is the indicator of the point's own slice, so the
weights do not depend on t. The velocity is the curl (d psi/dy, -d
psi/dx), so continuity holds identically.

The rows, around given coefficients u_bar (velocity u_bar = curl psi_bar),
each block max-|value| normalised and then weighted:

* momentum (the interior points of slices t > 0), for d = x, y:
  rho [(u_bar . grad) u_d + d u_d/dt] + dp/dx_d = rho g, the convective
  term rho (u . grad) u Picard-linearised around u_bar;
* walls (y = -1, y = 1, slices t > 0), weight w_bc: psi = 0 below and
  2 v_in above; u . n = 0;
* outlet (x = 1), weight w_bc: p = 0;
* inlet (x = -1, slices t > 0), weight w_bc: psi = v_in (y + 1); u_x =
  v_in; u_y = 0;
* initial (slice 0, all but the inlet): u_x = u_y = p = psi = 0;
* gauge: psi = 0 at the first bottom-wall point of each slice.

The solve: the per-site-block whitener W[b] = G[b]^(-1/2) of the Gram
blocks G[b] of the system's columns (eigenvalues floored at 1e-6 of the
block's largest, float64), then CGLS on A W from y0 = W^-1 x0, x0 = u_bar,
in chunks of `cgls_chunk` iterations, each chunk restarted from the best
iterate with a fresh residual; x = W y. Each fit records the phi = |A W y
- b|^2 at each chunk's end.

Random numbers: one CPU `torch.Generator` seeded with the run's seed draws
N(0, 1) A (S, 2, J, 2), tA, b and the initial coefficients u (S, 2, J), in
that order, then the collocation points (uniform in [-1, 1]^2) and the
four boundary strips (bottom, top, right, left, each boundary/4 points,
1e-4 thick), in that order; each slice holds the same points.

Departures from `models/vortex.py`, each written out here:

* the nearest sites by a direct squared distance and `topk`, the slot
  order within a row is then another; the sites beyond the four that
  enclose a point have weight zero in both, so a tie among them changes
  nothing but the zero slots' columns;
* a point's slice by rounding t (T - 1); sums written out elementwise
  where the program uses einsum; the products `A x` by a plain gather-sum
  and `A^T r` by `index_add_`, in blocks of rows; the Gram blocks summed
  in float64 (the program sums them in float32 and decomposes in float64);
* `half_batch` (a planted fault) leaves the second half of the interior
  points out of the momentum rows; `reverse` (a witness of rounding) takes
  the system's rows in reverse order; `run` counts chunks.

The whitener a fit uses is its own system's, or where the fit's `aux`
names `whiten_from` (the coefficients around which the system that made
the program's cached whitener was assembled), that system's: the
reference assembles it and decomposes its Gram itself.

Followed fits. A fit at or past the workload's `followed_from` (in the
cell: Picard index 3, past the published run's three) is compared by its
phi over its first `contact_iters` chunks alone, and its field is not
compared (the check's `contact_loss_gap`, its name for a fit it follows
part of the way). There the fixed-point iteration moves the field less
each step, down toward what a 2,000-iteration float32 solve resolves, so
|f_reference - f_start| stops measuring the fit: on an H100, at t = 39-45
the reference started one float32 ulp away, or with its rows reversed,
reads a field_gap of 0.04-0.27 against itself, where at t = 2 it reads
0.004-0.023, while its phi over the whole solve still agrees to 0.03-0.06.
Deeper still a solve moves phi by about 0.1%, and the phi comparison
fails too: at t = 88 the one-ulp start reads a contact_loss_gap of 0.82
against the reference (0.01-0.05 at t = 12). So the cell compares t = 0
and t = 2 (Picards 1 and 3, the published run's first and last) whole and
follows one named step, t = 12; every later step is held to its handoffs
(its start is the last step's result, its whitener the cached one's bits)
and to its iteration count.

Precision: float32 with TF32 off, the whitener's eigendecomposition in
float64. The control ("tf32") rounds the operator's values, the whitener
and every vector to TF32's 10-bit mantissa before every product (the
block-ELL products and the whitener's, and the Gram): this solve has no
matrix product that the card's TF32 switch would touch.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from .common import Precision, _round_tf32, cell_centres

PSI, PV = 0, 1
ROWS = 1 << 17          # rows per block of a product
GRAM_ROWS = 1 << 13     # rows per block of the Gram sum (J x J per slot)
EPS = 1e-4              # the boundary strips' half thickness


class System(NamedTuple):
    vals: torch.Tensor      # (R, 2K, J) float32, padding slots zero
    cols: torch.Tensor      # (R, 2K) int64 block ids (site * 2 + e)
    b: torch.Tensor         # (R,)
    n_blocks: int


def _smooth(r: torch.Tensor):
    """S(1 - |r|) and its first and second derivatives in r, zero outside
    |r| < 1."""
    a = torch.clamp(1.0 - torch.abs(r), 0.0, 1.0)
    inside = torch.abs(r) < 1.0
    v = a * a * (3.0 - 2.0 * a)
    g = -torch.sign(r) * 6.0 * a * (1.0 - a)
    h = torch.where(inside, 6.0 - 12.0 * a, torch.zeros_like(a))
    return v, g, h


class Reference:
    """The configuration's Picard fits, from its own random stream."""

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, inputs: dict):
        c = config
        want = {"formulation": "stream", "pou": "smooth",
                "pou_time": "simple", "time_window": 1, "stream_bc": "both",
                "outlet_v": False, "pou_normalize": True,
                "precondition": "block", "cgls_damp": 0.0,
                "reuse_whitener": True, "cgls_restart": True}
        for key, value in want.items():
            if c[key] != value:
                raise ValueError(f"vortex_channel_stream: {key} "
                                 f"{c[key]!r}, the reference has {value!r}")
        self.device = device
        self.nc, self.m = int(c["collocation"]), int(c["boundary"]) // 4
        self.T = int(c["time_num"])
        self.res = int(round(math.sqrt(c["n_spatial_basis"])))
        self.J, self.K = int(c["n_feat"]), int(c["neighbor_k"])
        self.rho, self.v_in = float(c["rho"]), float(c["internal_v"])
        self.gravity = float(c["gravity"])
        self.w_mom, self.w_bc, self.w_init = (float(c["w_momentum"]),
                                              float(c["w_bc"]),
                                              float(c["w_init"]))
        self.bw = float(c["band_width"])
        self.tlen = float(c["time_length"])
        self.tbw = self.tlen / max(self.T - 1, 1)
        self.h = 2.0 / self.res
        self.floor = float(c["eig_floor"])
        self.chunk, self.tol = int(c["cgls_chunk"]), float(c["cgls_tol"])
        self.warm = float(c["warm_start"])
        self.n_sites = self.res ** 2 * self.T
        self.n_blocks = self.n_sites * 2
        self.eval_res = int(workload["check"]["eval_resolution"])
        # the Picard index from which a fit is followed by its phi alone
        self.followed_from = workload["check"].get("followed_from")
        self.gen = torch.Generator()
        self.gen.manual_seed(seed)

    # ---- the random stream and the geometry ----
    def initial_weights(self) -> Dict[str, list]:
        """The coefficients first (the t = 0 fit starts from them), then
        the random basis and the points, all drawn here."""
        g, S, J, nc, m = self.gen, self.n_sites, self.J, self.nc, self.m

        def normal(*shape):
            return torch.randn(shape, generator=g, dtype=torch.float32)

        A, tA, bias, u = (normal(S, 2, J, 2), normal(S, 2, J),
                          normal(S, 2, J), normal(S, 2, J))
        colloc = -1.0 + 2.0 * torch.rand((nc, 2), generator=g)
        draw = torch.rand((4, m, 2), generator=g)
        lo = torch.tensor([[-1.0, -1.0 - EPS], [-1.0, 1.0 - EPS],
                           [1.0 - EPS, -1.0], [-1.0 - EPS, -1.0]])
        hi = torch.tensor([[1.0, -1.0 + EPS], [1.0, 1.0 + EPS],
                           [1.0 + EPS, 1.0], [-1.0 + EPS, 1.0]])
        strips = lo[:, None, :] + draw * (hi - lo)[:, None, :]
        spatial = torch.cat([colloc, strips.reshape(-1, 2)])
        self.ts = torch.linspace(0.0, self.tlen, self.T)
        x = spatial.repeat(self.T, 1)
        t = torch.repeat_interleave(self.ts, spatial.shape[0])

        dev = self.device
        self.A, self.tA, self.bias = A.to(dev), tA.to(dev), bias.to(dev)
        self.x, self.t, self.ts = x.to(dev), t.to(dev), self.ts.to(dev)
        self.centres = cell_centres(self.res, 2, dev)
        per = nc + 4 * m
        ids = torch.arange(self.T * per).reshape(self.T, per)
        groups = {"inner": ids[1:, :nc], "wall": ids[1:, nc:nc + 2 * m],
                  "outlet": ids[1:, nc + 2 * m:nc + 3 * m],
                  "inlet": ids[1:, nc + 3 * m:], "init": ids[0, :nc + 3 * m],
                  "gauge": torch.arange(self.T) * per + nc}
        self.ids = {k: v.reshape(-1).to(dev) for k, v in groups.items()}
        normal_y = torch.cat([torch.ones(m), -torch.ones(m)])
        self.wall_ny = normal_y.repeat(self.T - 1).to(dev)
        self.pb = {k: self._basis(self.x[v], self.t[v], k == "inner")
                   for k, v in self.ids.items()}
        grid = cell_centres(self.eval_res, 2, dev)
        self.eval_basis = [self._basis(grid, torch.full(
            (grid.shape[0],), float(s), device=dev), False)
            for s in self.ts.tolist()]
        zero = torch.zeros(1, device=dev)     # the pairs' second member
        return {"coefficients": [(u.to(dev), zero)],
                "basis": [(self.A, self.tA), (self.bias, zero)],
                "points": [(self.x, self.t)]}

    def _basis(self, x: torch.Tensor, t: torch.Tensor, second: bool):
        """The basis columns at points (x (Q, 2), t (Q,)): site ids n (Q,
        K) and, over (Q, K, 2, J), the values B, the gradient Bx (.., 2), the
        time derivative Bt and with `second` the Hessian Bxx (.., 2, 2) and
        the mixed Bxt (.., 2)."""
        K, bw, tbw = self.K, self.bw, self.tbw
        d2 = ((x[:, None, :] - self.centres[None, :, :]) ** 2).sum(-1)
        sidx = torch.topk(d2, K, dim=1, largest=False).indices
        slc = torch.round(t / self.tlen * (self.T - 1)).long()
        n = slc[:, None] * self.res ** 2 + sidx                   # (Q, K)
        dx = x[:, None, :] - self.centres[sidx]                   # (Q, K, 2)
        xr = dx / bw
        tr = ((t - self.ts[slc]) / tbw)[:, None, None, None]
        A = self.A[n]                                             # Q K E J 2
        tA = self.tA[n]
        z = (A[..., 0] * xr[:, :, None, None, 0]
             + A[..., 1] * xr[:, :, None, None, 1] + tA * tr + self.bias[n])
        s = torch.sigmoid(z)
        s1 = s * (1.0 - s)
        s2 = s1 * (1.0 - 2.0 * s)
        Ab = A / bw                                               # d z / dx
        tAb = tA / tbw                                            # d z / dt
        phi_x = s1[..., None] * Ab
        phi_t = s1 * tAb

        # the partition of unity: products of the smooth hat per axis,
        # times the slice indicator (1 for the point's own slice)
        inside = (torch.abs(tr[:, :, 0, 0]) <= 1.0).to(x.dtype)
        v, g, h = _smooth(dx / self.h)
        g, h = g / self.h, h / self.h ** 2
        w = v[..., 0] * v[..., 1] * inside                        # (Q, K)
        wx = torch.stack([g[..., 0] * v[..., 1], v[..., 0] * g[..., 1]],
                         -1) * inside[..., None]
        # Shepard normalisation by the quotient rule
        W = torch.clamp(w.sum(1, keepdim=True), min=1e-12)
        Wx = wx.sum(1, keepdim=True)
        wn = w / W
        wnx = wx / W[..., None] - w[..., None] * Wx / W[..., None] ** 2

        def e(a):          # (Q, K) -> (Q, K, 1, 1)
            return a[:, :, None, None]

        out = {"n": n, "B": e(wn) * s,
               "Bx": (e(wn)[..., None] * phi_x
                      + wnx[:, :, None, None, :] * s[..., None]),
               "Bt": e(wn) * phi_t}
        if second:
            off = g[..., 0] * g[..., 1]
            wxx = torch.stack([torch.stack([h[..., 0] * v[..., 1], off], -1),
                               torch.stack([off, v[..., 0] * h[..., 1]], -1)],
                              -2) * inside[..., None, None]
            Wxx = wxx.sum(1, keepdim=True)
            Wq = W[..., None, None]
            wnxx = (wxx / Wq
                    - (wx[..., :, None] * Wx[..., None, :]
                       + wx[..., None, :] * Wx[..., :, None]
                       + w[..., None, None] * Wxx) / Wq ** 2
                    + 2.0 * w[..., None, None] * Wx[..., :, None]
                    * Wx[..., None, :] / Wq ** 3)
            phi_xx = s2[..., None, None] * Ab[..., :, None] * Ab[..., None, :]
            phi_xt = s2[..., None] * Ab * tAb[..., None]
            wa = wnx[:, :, None, None, :, None]
            wb = wnx[:, :, None, None, None, :]
            out["Bxx"] = (wn[:, :, None, None, None, None] * phi_xx
                          + wa * phi_x[..., None, :] + wb * phi_x[..., :, None]
                          + wnxx[:, :, None, None] * s[..., None, None])
            out["Bxt"] = (e(wn)[..., None] * phi_xt
                          + wnx[:, :, None, None, :] * phi_t[..., None])
        return out

    # ---- the system ----
    def _vel(self, c: dict) -> torch.Tensor:
        """Velocity columns (Q, K, J, 2) of psi: (d/dy, -d/dx)."""
        bx = c["Bx"][:, :, PSI]
        return torch.stack([bx[..., 1], -bx[..., 0]], -1)

    def system(self, ubar: torch.Tensor, half_batch: bool = False,
               reverse: bool = False) -> System:
        """The Picard system around the coefficients ubar (S, 2, J)."""
        K, pb = self.K, self.pb
        blocks = []     # (vals (Q, s, J), site ids (Q, s), var, rhs, weight)

        def ids(c, var):
            return c["n"] * 2 + var

        ci = pb["inner"]
        if half_batch:
            q = ci["n"].shape[0] // 2
            ci = {k: v[:q] for k, v in ci.items()}
        # u_bar at the interior points, and the velocity's derivative
        # columns: du_d/dx_b and du_d/dt
        ub_coef = ubar[ci["n"], PSI]                              # (Q, K, J)
        bx = ci["Bx"][:, :, PSI]
        ubar_x = (bx[..., 1] * ub_coef).sum((1, 2))
        ubar_y = -(bx[..., 0] * ub_coef).sum((1, 2))
        bxx, bxt = ci["Bxx"][:, :, PSI], ci["Bxt"][:, :, PSI]
        grad = {0: bxx[..., 1, :], 1: -bxx[..., 0, :]}     # (Q, K, J, 2)
        dtu = {0: bxt[..., 1], 1: -bxt[..., 0]}
        for d in range(2):
            conv = (grad[d][..., 0] * ubar_x[:, None, None]
                    + grad[d][..., 1] * ubar_y[:, None, None])
            v_psi = self.rho * (conv + dtu[d])
            v_p = ci["Bx"][:, :, PV, :, d]
            blocks.append((torch.cat([v_psi, v_p], 1),
                           torch.cat([ids(ci, PSI), ids(ci, PV)], 1),
                           torch.full((v_psi.shape[0],),
                                      self.gravity * self.rho,
                                      device=v_psi.device), self.w_mom))
        cw = pb["wall"]
        zero = torch.zeros(cw["n"].shape[0], device=self.device)
        blocks.append((cw["B"][:, :, PSI], ids(cw, PSI),
                       torch.where(self.wall_ny > 0, 0.0, 2.0 * self.v_in),
                       self.w_bc))
        # u . n with n = (0, n_y)
        blocks.append((self._vel(cw)[..., 1] * self.wall_ny[:, None, None],
                       ids(cw, PSI), zero, self.w_bc))
        co = pb["outlet"]
        blocks.append((co["B"][:, :, PV], ids(co, PV),
                       torch.zeros(co["n"].shape[0], device=self.device),
                       self.w_bc))
        cl = pb["inlet"]
        y = self.x[self.ids["inlet"], 1]
        vel = self._vel(cl)
        blocks.append((cl["B"][:, :, PSI], ids(cl, PSI),
                       self.v_in * (y + 1.0), self.w_bc))
        blocks.append((vel[..., 0], ids(cl, PSI),
                       torch.full_like(y, self.v_in), self.w_bc))
        blocks.append((vel[..., 1], ids(cl, PSI), torch.zeros_like(y),
                       self.w_bc))
        c0 = pb["init"]
        vel = self._vel(c0)
        z0 = torch.zeros(c0["n"].shape[0], device=self.device)
        blocks += [(vel[..., 0], ids(c0, PSI), z0, self.w_init),
                   (vel[..., 1], ids(c0, PSI), z0, self.w_init),
                   (c0["B"][:, :, PV], ids(c0, PV), z0, self.w_init),
                   (c0["B"][:, :, PSI], ids(c0, PSI), z0, self.w_init)]
        cg = pb["gauge"]
        blocks.append((cg["B"][:, :, PSI], ids(cg, PSI),
                       torch.zeros(cg["n"].shape[0], device=self.device),
                       self.w_init))

        vals, cids, rhs = [], [], []
        for v, c, r, w in blocks:
            pad = 2 * K - v.shape[1]
            if pad:
                v = torch.cat([v, v.new_zeros(v.shape[0], pad, v.shape[2])], 1)
                c = torch.cat([c, c.new_zeros(c.shape[0], pad)], 1)
            scale = torch.clamp(torch.max(torch.abs(v)), min=1e-30)
            vals.append(v / (scale / w))
            cids.append(c)
            rhs.append(r / (scale / w))
        sys_ = System(torch.cat(vals), torch.cat(cids), torch.cat(rhs),
                      self.n_blocks)
        if reverse:
            sys_ = System(sys_.vals.flip(0), sys_.cols.flip(0),
                          sys_.b.flip(0), sys_.n_blocks)
        return sys_

    # ---- products ----
    def _mv(self, vals, cols, x):
        X = x.reshape(-1, self.J)
        return torch.cat([(vals[i:i + ROWS] * X[cols[i:i + ROWS]]).sum((1, 2))
                          for i in range(0, vals.shape[0], ROWS)])

    def _rmv(self, vals, cols, r):
        out = torch.zeros((self.n_blocks, self.J), device=r.device)
        for i in range(0, vals.shape[0], ROWS):
            out.index_add_(0, cols[i:i + ROWS].reshape(-1),
                           (vals[i:i + ROWS] * r[i:i + ROWS, None, None])
                           .reshape(-1, self.J))
        return out.reshape(-1)

    def _whitener(self, s: System, tf32: bool) -> torch.Tensor:
        """W (n_blocks, J, J) float32 from the float64 Gram blocks."""
        J = self.J
        vals = _round_tf32(s.vals) if tf32 else s.vals
        G = torch.zeros((s.n_blocks, J, J), dtype=torch.float64,
                        device=vals.device)
        for i in range(0, vals.shape[0], GRAM_ROWS):
            v = vals[i:i + GRAM_ROWS].double()
            G.index_add_(0, s.cols[i:i + GRAM_ROWS].reshape(-1),
                         (v[..., :, None] * v[..., None, :]).reshape(-1, J, J))
        G = G.cpu()
        w, V = torch.linalg.eigh(G)
        wmax = torch.clamp(w[:, -1:], min=0.0)
        denom = torch.maximum(w, torch.clamp(self.floor * wmax, min=1e-300))
        W = (V / torch.sqrt(denom)[:, None, :]) @ V.transpose(1, 2)
        W[wmax[:, 0] <= 0.0] = torch.eye(J, dtype=torch.float64)
        return W.float().to(vals.device)

    # ---- the fits ----
    def skip(self, tag: str, iters: int) -> None:
        """A fit draws nothing: nothing to skip."""

    def fit(self, tag: str, start, aux: dict, iters: int, prec: Precision,
            half_batch: bool = False, run=None, contact_iters=None,
            reverse: bool = False):
        """One Picard iteration from the coefficients `start`: the system
        around them, the whitener of `aux`'s system, CGLS of `iters`
        iterations warm-started from them. Returns ([(coefficients, a
        one-element zero)], {"phi": the phi at each chunk's end}, whether
        the fit is compared whole). A fit at Picard index `aux["t"]` at or
        past the workload's `followed_from` is followed for its first
        `contact_iters` chunks and compared by its phi alone (False);
        every other fit whole (True). `run`, where given, ends the fit after
        that many chunks."""
        if tag != "picard":
            raise ValueError(f"vortex_channel_stream: no phase {tag!r}")
        whole = (self.followed_from is None
                 or aux.get("t", 0) < self.followed_from)
        if not whole:
            # the check passes contact_iters to its own run of the fit, and
            # the chunks that run read to the other modes' runs
            cut = [n for n in (run, contact_iters) if n is not None]
            if not cut:
                raise ValueError("vortex_channel_stream: a followed fit "
                                 "needs the workload's contact_iters")
            run = min(cut)
        tf32 = prec.mode == "tf32"
        ubar = start[0][0]
        with torch.no_grad(), prec.active():
            s = self.system(ubar, half_batch, reverse)
            source = aux.get("whiten_from")
            ws = s if source is None else self.system(source[0][0],
                                                      half_batch, reverse)
            W = self._whitener(ws, tf32)
            x0 = (ubar * self.warm).reshape(-1)
            y0 = torch.zeros_like(x0)
            if bool(torch.any(x0 != 0)):
                y0 = torch.linalg.solve(
                    W.double(), x0.double().reshape(self.n_blocks, -1, 1)
                )[..., 0].reshape(-1).float()
            y, phis = self._cgls(s, W, y0, iters, run, tf32)
            x = self._apply(W, y, tf32)
        hist = {"phi": torch.tensor(phis, dtype=torch.float64)}
        return [(x.reshape(ubar.shape), ubar.new_zeros(1))], hist, whole

    def _apply(self, W, y, tf32):
        if tf32:
            W, y = _round_tf32(W), _round_tf32(y)
        return (W * y.reshape(self.n_blocks, 1, self.J)).sum(-1).reshape(-1)

    def _cgls(self, s: System, W, y0, maxiter: int, run, tf32: bool):
        """CGLS on A W with the program's rule: each iteration takes effect
        while gamma > tol^2 gamma_0, k < maxiter and phi < 1e4 best phi;
        the host reads k, gamma, phi and the best phi after each chunk,
        stops where the rule or a stall says so, else restarts from the
        best iterate with an exact residual. Returns (the final iterate,
        or the best where the final's phi is above twice the best's; the
        phi read at each chunk's end)."""
        vals = _round_tf32(s.vals) if tf32 else s.vals

        def rnd(v):
            return _round_tf32(v) if tf32 else v

        def mv(y):
            return self._mv(vals, s.cols, rnd(self._apply(W, y, tf32)))

        def rmv(r):
            return self._apply(W, self._rmv(vals, s.cols, rnd(r)), tf32)

        def begin(y):
            r = s.b - mv(y)
            p = rmv(r)
            return r, p, torch.dot(p, p), torch.dot(r, r)

        y = y0
        r, p, gamma, phi = begin(y)
        k = torch.zeros((), dtype=torch.int64, device=y.device)
        best_y, best_phi = y, phi
        stop2 = self.tol ** 2 * float(gamma)
        phis, done, chunks = [], 0, 0
        while True:
            for _ in range(max(min(self.chunk, maxiter - done), 0)):
                active = ((gamma > stop2) & (k < maxiter)
                          & (phi < 1e4 * best_phi))
                q = mv(p)
                qq = torch.dot(q, q)
                alpha = gamma / torch.where(qq == 0, 1e-30, qq)
                y_n, r_n = y + alpha * p, r - alpha * q
                s_n = rmv(r_n)
                gamma_n = torch.dot(s_n, s_n)
                beta = gamma_n / torch.where(gamma == 0, 1e-30, gamma)
                p_n = s_n + beta * p
                phi_n = torch.dot(r_n, r_n)
                better = phi_n < best_phi
                best_y = torch.where(active & better, y_n, best_y)
                best_phi = torch.where(active & better, phi_n, best_phi)
                y, r, p = (torch.where(active, a, b)
                           for a, b in ((y_n, y), (r_n, r), (p_n, p)))
                gamma = torch.where(active, gamma_n, gamma)
                phi = torch.where(active, phi_n, phi)
                k = k + active.long()
            k_h, gamma_h, phi_h, best_h = torch.stack(
                [k.double(), gamma.double(), phi.double(),
                 best_phi.double()]).tolist()
            phis.append(phi_h)
            chunks += 1
            if (k_h >= maxiter or gamma_h <= stop2 or int(k_h) == done
                    or phi_h >= 1e4 * best_h
                    or (run is not None and chunks >= run)):
                break
            done = int(k_h)
            y = torch.where(phi <= best_phi, y, best_y)
            r, p, gamma, phi_f = begin(y)
            better = phi_f < best_phi
            best_y = torch.where(better, y, best_y)
            best_phi = torch.where(better, phi_f, best_phi)
            phi = phi_f
        final = torch.where(phi <= 2.0 * best_phi, y, best_y)
        return final, phis

    # ---- the compared field ----
    def field(self, params, prec: Precision) -> torch.Tensor:
        """The velocity (T r^2, 2) of the coefficients `params` on the
        check's r x r grid of cell centres at each slice time."""
        u = params[0][0]
        out = []
        with torch.no_grad():
            for c in self.eval_basis:
                coef = u[c["n"], PSI]
                bx = c["Bx"][:, :, PSI]
                out.append(torch.stack([(bx[..., 1] * coef).sum((1, 2)),
                                        -(bx[..., 0] * coef).sum((1, 2))],
                                       -1))
        return torch.cat(out)
