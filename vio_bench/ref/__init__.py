"""The plain reference of the benchmark's comparison: a frozen copy of
`pose_estimation_tpu_torch`'s eager frame step (`models.vio.ok_step` and
what it calls, keyframe full BA among it where a configuration turns it
on) and batched step (`parallel.batched`), cut to what the cells run,
with every hand kernel replaced by its plain PyTorch twin (K1
`fast.select_plain`, K3 `fast.score_nms_plain`, K2 in the kernel's own
order of arithmetic `sample.sample_patches_exact`, K6
`small_linalg.eigh_plain`) and the graphs' conditional nodes by their
eager forms (`graphs.py`: the fixed LM loop and the select). It imports
nothing of the program, so a later change to the program does not move
the yardstick; `check.py` drives it.
"""
