"""capture_s (tick graph): seconds set-up spent capturing tick programs as
CUDA graphs (``compile_cache.stats()["capture_s"]`` after the warm grid);
nothing where set-up captured none."""


def read(obs):
    st = obs["setup_stats"]
    return st["capture_s"] if st.get("captures") else None
