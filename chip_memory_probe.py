"""Where the card's memory goes while ``chip_smoke.py``'s phases run: a
thread samples the card's used memory (``torch.cuda.mem_get_info``, every
process on the card) beside this process's reserved bytes every 20 ms and
prints each jump of their difference (the CUDA context, other processes:
the fresh processes and ranks a phase starts) by more than 0.5 GiB; after
each phase its peaks.  Runs the kernel checks of #1 and #3/#4, writes the
fixture, then the phases named on the command line, in one process:

    python3 chip_memory_probe.py zoo_path k2_path wav2vec_path cv_path

Needs the card; imports nothing of JAX."""
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch
import chip_smoke as cs

T0 = time.perf_counter()
real_log = cs.log
cs.log = lambda m: real_log(f"[{time.perf_counter() - T0:7.1f}] {m[:300]}")
GB = 2**30
DATA_PHASES = ("train_path", "zoo_path", "k1_path", "k2_path", "cv_path", "cv_mesh_path")
state = {"last": 0.0, "peak_other": 0.0, "peak_used": 0.0, "stop": False}


def sample():
    free, total = torch.cuda.mem_get_info()
    used = (total - free) / GB
    other = used - torch.cuda.memory_reserved() / GB
    return used, other


def sampler():
    torch.cuda.set_device(0)
    while not state["stop"]:
        used, other = sample()
        state["peak_other"] = max(state["peak_other"], other)
        state["peak_used"] = max(state["peak_used"], used)
        if abs(other - state["last"]) > 0.5:
            real_log(f"[{time.perf_counter() - T0:7.1f}] MEM other {other:.2f} GiB (was "
                     f"{state['last']:.2f}), used {used:.2f}, reserved "
                     f"{torch.cuda.memory_reserved() / GB:.2f}")
            state["last"] = other
        time.sleep(0.02)


def phase(fn, *a):
    state["peak_other"] = state["peak_used"] = 0.0
    torch.cuda.reset_peak_memory_stats()
    out = fn(*a)
    torch.cuda.synchronize()
    used, other = sample()
    real_log(f"[{time.perf_counter() - T0:7.1f}] PHASE {fn.__name__}: peak used "
             f"{state['peak_used']:.2f} GiB, peak other {state['peak_other']:.2f}, max reserved "
             f"{torch.cuda.max_memory_reserved() / GB:.2f}; now used {used:.2f}, other {other:.2f}")
    torch.cuda.empty_cache()
    used, other = sample()
    real_log(f"   after empty_cache: used {used:.2f}, other {other:.2f}")
    return out


torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs._build.build()
cs._build.load()
torch.cuda.init()
threading.Thread(target=sampler, daemon=True).start()
gen = torch.Generator().manual_seed(0)
x, params = cs.block_case(gen)
phase(cs.check_block, x, params)
phase(cs.check_lstm, gen)
phase(cs.check_lstm_backward, gen)
data = cs.write_fixture()
for name in sys.argv[1:]:
    fn = getattr(cs, name)
    phase(fn, *((data,) if name in DATA_PHASES else ()))
state["stop"] = True
