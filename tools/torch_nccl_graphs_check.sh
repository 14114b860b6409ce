#!/usr/bin/env bash
# Several NCCL ranks on the while_loop graph route, on a machine with four
# GPUs, in one command (build once, then everything), from the repository
# root:
#
#   bash tools/torch_nccl_graphs_check.sh [PARENT_DIR]
#
# 1. tools/torch_collective_graph_probe.py for each structure a captured
#    collective can sit in: plain, if, while, if_if (an IF body inside an
#    IF body: a guarded step's periodic replacement before guard.sibling),
#    sibling (the structure the driver captures now), and if_if_after and
#    sibling_after (the same with collectives in the outer body first);
# 2. with PARENT_DIR (another checkout, e.g. an unpacked `git archive` of
#    the parent commit): its cg_pipelined and cg_block weak scaling on the
#    graph route past their replacement, Python's fault handler on, to
#    show where a crash comes from;
# 3. this checkout's weak scaling of cg, cg_pipelined and cg_block on
#    both routes past the replacement (bit_equal in each JSON line);
# 4. tools/torch_multigpu_check.py --nccl-graphs (every case on three
#    routes, bit for bit);
# 5. tests/test_torch_cuda.py -k four_nccl in a copy of this checkout whose
#    parallel.solve.NCCL_GRAPHS is True.
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

for kind in plain if while if_if sibling if_if_after sibling_after; do
  spmd "probe_$kind" . tools/torch_collective_graph_probe.py --kind "$kind"
done

small=(--rows-per-device 1048576 --iters 200 --repeats 2 --nccl-graphs)
if [ -n "$parent" ]; then
  for s in cg_pipelined cg_block; do
    spmd "parent_weak_$s" "$parent" tools/torch_weak_scaling.py --solver "$s" --route rule \
      "${small[@]}"
  done
fi
for s in cg cg_pipelined cg_block; do
  spmd "weak_$s" . tools/torch_weak_scaling.py --solver "$s" --replace-every 50 "${small[@]}"
done

spmd multigpu_check . tools/torch_multigpu_check.py --nccl-graphs
grep -a 'all .* sharded solves held' "$out/multigpu_check.log"

flipped=_archive/nccl_graphs_on
rm -rf "$flipped" && mkdir -p "$flipped"
cp -r krylov_tpu_torch tests chip_smoke.py "$flipped"/
sed -i 's/^NCCL_GRAPHS = False/NCCL_GRAPHS = True/' "$flipped/krylov_tpu_torch/parallel/solve.py"
(cd "$flipped" && timeout -k 10 400 python3 -m pytest --noconftest -q -p no:cacheprovider \
  tests/test_torch_cuda.py -k four_nccl) > "$out/pytest_four_nccl.log" 2>&1
echo "pytest four_nccl (NCCL_GRAPHS on) rc=$?"
tail -3 "$out/pytest_four_nccl.log"
echo "seconds $(( $(date +%s) - t0 ))"
