"""The system's benchmark entry points on the port, each the counterpart
of one JAX script at the repository's root:

    python -m detectinblur_tpu_torch.bench.serve      # bench.py
    python -m detectinblur_tpu_torch.bench.train      # bench_train.py
    python -m detectinblur_tpu_torch.bench.pipeline   # bench_pipeline.py

Each prints one JSON line, with its JAX twin's keys, as the last line of
stdout, and everything else on stderr. They run on CUDA unless
``--device cpu`` is given; the kernels build at first use.
"""
