"""Tools around the port's nets and train step, the counterparts of the
JAX package's scripts (``scripts/`` and the repo root's):

- ``golden_depth``: the pretrained MiDaS / hourglass golden check
  (``scripts/depth_golden_check.py``);
- ``golden_raft``: the pretrained RAFT golden check
  (``scripts/raft_golden_check.py``);
- ``step_profile``: a trace of the canonical train step split by device
  time (``scripts/step_profile.py``);
- ``roofline``: every convolution shape of the MiDaS step timed against the
  card's peak (``scripts/roofline.py``);
- ``bench``: every leg of ``bench.py``, the bf16 train step at its
  batches, gaps and sizes;
- ``release_gate``: the port's tests, the fleet's dry run on gloo ranks
  and the bench against the gate's own last green record
  (``scripts/release_gate.py``).

Each is run as ``python -m dynamic_video_depth_tpu_torch.tools.<name>``.
Importing them builds and touches nothing; the timing paths need a card.
"""
