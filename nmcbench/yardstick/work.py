"""Operations and bytes of a SIREN frame, counted from a configuration's
shapes. `iteration_work` is a frozen copy of
nmcfluid_torch/sim/fitkernel.py::iteration_work, taking the sizes as
plain numbers."""


def siren_macs(d_in, d_out, hidden, layers):
    """Multiply-adds of one forward evaluation of a SIREN with `layers`
    hidden-to-hidden layers of width `hidden`."""
    return d_in * hidden + layers * hidden * hidden + hidden * d_out


def iteration_work(d_in, d_out, hidden, layers, batch):
    """(bytes, flops) of one Adam iteration at batch B, the least any
    implementation must move and compute: the SIREN's forward MACs and
    twice as many backward, at 2 flops a MAC; one pool batch (x, A, c,
    target, w) read, and the params, m and v read and written once."""
    H, Lh, D_in, D_out = hidden, layers, d_in, d_out
    macs = D_in * H + Lh * H * H + H * D_out
    n_params = macs + (Lh + 1) * H + D_out
    n_bytes = 4 * (batch * (D_in + D_out * D_out + 3 * D_out + 1)
                   + 6 * n_params)
    return n_bytes, 2 * 3 * macs * batch


def net_shape(cfg):
    """(d_in, d_out, hidden, layers) of a configuration file's network."""
    s = cfg["scene_fields"]
    return s["dim"], s["dim"], s["hidden_features"], s["num_hidden_layers"]


def fit_work(cfg):
    """(bytes, flops) of the Adam iterations of one frame: two phase fits
    of max_n_iters iterations at the configuration's batch."""
    s = cfg["scene_fields"]
    b, fl = iteration_work(*net_shape(cfg), s["sample_resolution"] ** 2)
    n = 2 * s["max_n_iters"]
    return n * b, n * fl


def frame_flops(cfg):
    """The SIREN's float32 operations that one frame needs, at 2 flops a
    multiply-add:
      - the fits' Adam iterations (fit_work);
      - the pool targets: the advection pool's two forward passes a point
        (u_prev at x and at the back trace) and the projection pool's one
        (u_prev at x), over fit_pool batches;
      - each fit's head solve: ls_head batches of the batch's forward
        passes, the trunk's features and the residual's forward pass, and
        one more batch for the two losses that accept the solve;
      - the divergence grid: a forward pass with one tangent an axis
        (1 + D passes' multiply-adds a point).
    Walk steps read the divergence grid, not the network, and count
    nothing here."""
    d_in, d_out, h, lh = net_shape(cfg)
    s, f = cfg["scene_fields"], cfg["fluid"]
    macs = siren_macs(d_in, d_out, h, lh)
    B, K, L = s["sample_resolution"] ** 2, f["fit_pool"], f["ls_head"]
    fwd = 2 * macs * B                 # one forward pass over a batch
    fits = fit_work(cfg)[1]
    pools = K * (2 + 1) * fwd
    # advection: batch (2) + features (1) + residual (1); projection:
    # batch (1) + 2; the acceptance batch: its targets + two losses
    heads = L * (4 + 3) * fwd + (2 + 2 + 1 + 2) * fwd
    grid = f["div_resolution"] ** d_in * 2 * macs * (1 + d_in)
    return fits + pools + heads + grid
