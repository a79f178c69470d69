"""Preprocessing of a raw video into the trainer's packed pairs (counterpart
of ``dynamic_video_depth_tpu/preprocess``): stage 1 ``frames`` (MiDaS depth
init and scale calibration), stage 2 ``flows`` (RAFT flows and occlusion
masks), stage 3 ``pairs`` (packed ``.pt`` pairs). The entry is
``python -m dynamic_video_depth_tpu_torch.preprocess`` (``run_davis.py``).
"""
