#!/usr/bin/env bash
# Several NCCL ranks on the while_loop graph route, on a machine with four
# GPUs, in one command (build once, then everything), from the repository
# root:
#
#   bash tools/torch_nccl_graphs_check.sh [PARENT_DIR]
#
# 1. with PROBES=1, tools/torch_collective_graph_probe.py for each
#    structure a captured collective can sit in: plain, if, while, if_if
#    (an IF body inside an IF body: a guarded step's periodic replacement
#    before guard.sibling), sibling (the structure the driver captures
#    now), and if_if_after and sibling_after (the same with collectives in
#    the outer body first);
# 2. with PARENT_DIR (another checkout, e.g. an unpacked `git archive` of
#    the parent commit): this checkout's tools/torch_multigpu_check.py
#    over its package, the built solvers' cases alone, with the solvers
#    alive and then dropped at the process group's teardown, the fault
#    handler armed to show where the end hangs;
# 3. this checkout's weak scaling of cg, cg_pipelined and cg_block on
#    both routes past the replacement (bit_equal in each JSON line);
# 4. tools/torch_multigpu_check.py (every case on three routes, bit for
#    bit; the built solvers alive at the end);
# 5. tests/test_torch_cuda.py -k four_nccl.
#
# END_ONLY=1 skips steps 3 and 5 (the teardown's evidence alone).
#
# WEAK_AB=1 with PARENT_DIR runs only a control of step 3 on one machine:
# the weak scaling of cg in the parent, this checkout, this checkout, the
# parent, then cg_pipelined and cg_block in the parent and this checkout
# (the parent's tool with --nccl-graphs where it has that switch).
#
# Every run has NCCL_GRAPH_MIXING_SUPPORT=0.  Each run's whole log goes to
# $OUT (default nccl_graphs_logs/); its exit code and JSON lines are printed.
set -u
cd "$(dirname "$0")/.."
out=${OUT:-nccl_graphs_logs}
mkdir -p "$out"
export NCCL_GRAPH_MIXING_SUPPORT=0 PYTHONFAULTHANDLER=1 OMP_NUM_THREADS=1
parent=${1:-}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'

build() {
  (cd "$1" && python3 -c 'from krylov_tpu_torch import _build; _build.build()') \
    > "$out/build_$2.log" 2>&1
  echo "build $2 rc=$?"
}

spmd() {  # name, directory, script and arguments
  local name=$1 dir=$2
  shift 2
  (cd "$dir" && timeout -k 10 240 python3 -m torch.distributed.run --standalone \
    --nproc-per-node 4 "$@") > "$out/$name.log" 2>&1
  local rc=$?
  echo "$name rc=$rc"
  grep -a '^{' "$out/$name.log" | tail -4
  grep -a -m3 'Fatal Python error\|Segmentation fault\|signal 11\|SIGSEGV\|Error' "$out/$name.log"
}

t0=$(date +%s)
build . this
[ -n "$parent" ] && build "$parent" parent

if [ "${PROBES:-0}" = 1 ]; then
  for kind in plain if while if_if sibling if_if_after sibling_after; do
    spmd "probe_$kind" . tools/torch_collective_graph_probe.py --kind "$kind"
  done
fi

small=(--rows-per-device 1048576 --iters 200 --repeats 2)
if [ -n "$parent" ] && [ "${WEAK_AB:-0}" = 1 ]; then
  pflag=()
  grep -q -- '--nccl-graphs' "$parent/tools/torch_weak_scaling.py" && pflag=(--nccl-graphs)
  for run in cg:parent cg:this cg:this2 cg:parent2 cg_pipelined:parent cg_pipelined:this \
      cg_block:parent cg_block:this; do
    s=${run%%:*} side=${run#*:}
    if [ "${side%2}" = parent ]; then
      spmd "ab_${side}_$s" "$parent" tools/torch_weak_scaling.py --solver "$s" \
        --replace-every 50 "${small[@]}" "${pflag[@]}"
    else
      spmd "ab_${side}_$s" . tools/torch_weak_scaling.py --solver "$s" --replace-every 50 \
        "${small[@]}"
    fi
  done
  echo "seconds $(( $(date +%s) - t0 ))"
  exit 0
fi

if [ -n "$parent" ]; then
  cp tools/torch_multigpu_check.py "$parent/tools/"
  for solvers in alive dropped; do
    spmd "parent_end_$solvers" "$parent" tools/torch_multigpu_check.py --only-built \
      --solvers "$solvers" --hang-dump 45
    grep -a '^rank [0-9]\|Timeout (\|in destroy_process_group\|in barrier\|check.py", line' \
      "$out/parent_end_$solvers.log" | head -30
  done
fi

[ "${END_ONLY:-0}" = 1 ] || for s in cg cg_pipelined cg_block; do
  spmd "weak_$s" . tools/torch_weak_scaling.py --solver "$s" --replace-every 50 "${small[@]}"
done

spmd multigpu_check . tools/torch_multigpu_check.py --hang-dump 120
grep -a 'all .* sharded solves held\|^rank ' "$out/multigpu_check.log"

if [ "${END_ONLY:-0}" = 1 ]; then echo "seconds $(( $(date +%s) - t0 ))"; exit 0; fi
timeout -k 10 400 python3 -m pytest --noconftest -q -p no:cacheprovider \
  tests/test_torch_cuda.py -k four_nccl > "$out/pytest_four_nccl.log" 2>&1
echo "pytest four_nccl rc=$?"
tail -3 "$out/pytest_four_nccl.log"
echo "seconds $(( $(date +%s) - t0 ))"
