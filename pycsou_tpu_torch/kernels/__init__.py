"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions: K1 ``conv2d.sepconv2d``, K2 ``conv2d.sepgram2d``, K3
``tv.tv_pds_sweep_step_stats``, K4 ``tvr.tv_pds_megar_step``, K5
``tv.tv_pds_sweepm_step_stats``, K6 ``tv.tv_pds_sweepm2_step``, K7
``tvr.tv_pds_megarm_step``."""
