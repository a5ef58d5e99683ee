"""Runtime support: randomness, memory planning, device meshes, timing,
conversion, checkpoints, display helpers and the serving bundle
(``ServingBundle`` loads on first use: it imports the device operators,
which import this package)."""
from polara_tpu_torch.runtime.checkpoint import load_factors, save_factors
from polara_tpu_torch.runtime.display import print_frames, suppress_stdout
from polara_tpu_torch.runtime.memory import (array_split,
                                             get_available_memory,
                                             get_chunk_size, pad_dim,
                                             plan_user_chunks,
                                             range_division,
                                             read_npz_from_url)
from polara_tpu_torch.runtime.mesh import (get_default_mesh, make_mesh,
                                           set_default_mesh, shard_rows,
                                           use_mesh, user_sharding)
from polara_tpu_torch.runtime.rng import (check_random_state, key_from_seed,
                                          random_seeds)
from polara_tpu_torch.runtime.timing import (enable_compilation_cache,
                                             format_elapsed_time,
                                             profiler_trace, timed_blocked,
                                             track_time)

__all__ = ["track_time", "timed_blocked", "format_elapsed_time",
           "profiler_trace", "enable_compilation_cache",
           "check_random_state", "random_seeds", "key_from_seed",
           "plan_user_chunks", "range_division", "pad_dim", "array_split",
           "get_chunk_size", "get_available_memory", "read_npz_from_url",
           "save_factors",
           "load_factors", "print_frames", "suppress_stdout", "make_mesh",
           "user_sharding", "shard_rows", "set_default_mesh",
           "get_default_mesh", "use_mesh", "ServingBundle"]


def __getattr__(name):
    if name == "ServingBundle":
        from polara_tpu_torch.runtime.serving import ServingBundle
        return ServingBundle
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
