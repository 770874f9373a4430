"""Hand-written CUDA kernels for Hopper (``csrc/``) with their plain
PyTorch versions: K1 ``conv2d.sepconv2d``, K2 ``conv2d.sepgram2d``, K3
``tv.tv_pds_sweep_step_stats``, K4 ``tvr.tv_pds_megar_step``, K5
``tv.tv_pds_sweepm_step_stats``, K6 ``tv.tv_pds_sweepm2_step``, K7
``tvr.tv_pds_megarm_step``, K8 ``fista.lasso_fista_step``, K9
``langevin.pmyula_mega_step``, K10 ``tv.tv_pds_mega3_step``, K11
``tv.tv_pds_mega2_step``, K12 ``tv.tv_pds_mega_step``, K13
``tv.tv_pds_stencil_step``; ``band`` holds the rank-1 Gram's plain band
passes."""
