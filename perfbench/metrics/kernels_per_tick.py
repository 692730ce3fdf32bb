"""kernels_per_tick (tick graph and protocol ticks): the kernel launches the
window's graph replays made, per replay (``compile_cache.stats()``:
``graph_kernel_launches / replays``, counted from each captured graph's own
kernel nodes)."""


def read(obs):
    st = obs["window_stats"]
    if not st.get("replays"):
        return None
    return st["graph_kernel_launches"] / st["replays"]
