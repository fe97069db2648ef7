"""BASD in PyTorch for NVIDIA Hopper: the port of `basd_tpu`.

Imports torch and numpy only. Entry points (`train.main`,
`evaluate.main`, `create_student`, `load_teacher`, `make_train_step`, ...)
run on the CUDA card unless the caller passes `device="cpu"`; every
hand-written kernel's wrapper launches the kernel for a CUDA tensor and
takes its plain torch version only for a CPU tensor.
"""
