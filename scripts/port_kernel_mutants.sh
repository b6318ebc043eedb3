#!/bin/sh
# Mutant check of the PyTorch/CUDA port's kernel comparisons: shows that
# `chip_smoke.py --kernels-only` catches a kernel that forgets a mask, a
# border or a tap. Each mutant is a one-line edit of a CUDA source, made in a
# throw-away copy of the port (under $TMPDIR, removed on exit); the copy's
# kernel phase must then fail, and the line at which it failed is printed
# with the error it measured against the 2e-2 limit.
#
#     sh scripts/port_kernel_mutants.sh [mutant ...]
#
# Needs a CUDA card and nvcc. With no argument it runs every mutant, about
# a minute each. Exits 0 when every mutant was caught, 1 when one survived
# or an edit no longer applies to the source.
set -u

root=$(cd "$(dirname "$0")/.." && pwd)
work=$(mktemp -d) || exit 1
trap 'rm -rf "$work"' EXIT

# name | file under rich_text_to_image_tpu_torch/csrc | sed expression
mutants='attn_ragged_mask|attention.cu|s/col < kv_len ? s\[nb\]\[e\] \* scale_log2 : -INFINITY/s[nb][e] * scale_log2/
stream_ragged_mask|attention_stream.cu|s/live ? s\[mi\]\[nb\]\[e\] \* scale_log2 : -INFINITY/s[mi][nb][e] * scale_log2/
conv_columns_wrap|conv.cu|s/ww >= 0 \&\& ww < W;/a_pix[i] + dy * W + dx >= 0 \&\& a_pix[i] + dy * W + dx < M;/
conv_taps_mirrored|conv.cu|s/dx = tap % 3 - 1;/dx = 1 - tap % 3;/'

# attn_ragged_mask: the full-row kernels score the zero-filled keys past a
#   ragged end instead of masking them.
# stream_ragged_mask: the same in the streaming kernel.
# conv_columns_wrap: a tap that leaves the image sideways reads the
#   neighbouring image row instead of zero (still inside the tensor).
# conv_taps_mirrored: the three taps of each kernel row in reverse order.

want=${*:-$(printf '%s\n' "$mutants" | cut -d'|' -f1)}
bad=0
for name in $want; do
  spec=$(printf '%s\n' "$mutants" | grep "^$name|") || {
    echo "mutant $name: unknown"; bad=1; continue; }
  file=$(printf '%s' "$spec" | cut -d'|' -f2)
  expr=$(printf '%s' "$spec" | cut -d'|' -f3-)
  dir="$work/$name"
  mkdir -p "$dir"
  cp "$root/chip_smoke.py" "$dir/"
  cp -r "$root/rich_text_to_image_tpu_torch" "$dir/"
  rm -rf "$dir/rich_text_to_image_tpu_torch/_build"
  src="$dir/rich_text_to_image_tpu_torch/csrc/$file"
  sed -i "$expr" "$src"
  if cmp -s "$src" "$root/rich_text_to_image_tpu_torch/csrc/$file"; then
    echo "mutant $name: the edit does not apply to $file any more"
    bad=1
    continue
  fi
  (cd "$dir" && python3 chip_smoke.py --kernels-only) > "$dir/log" 2>&1
  rc=$?
  if [ "$rc" -ne 0 ] && grep -q "disagrees with its plain version" "$dir/log"
  then
    echo "mutant $name: caught (exit $rc) at: $(grep '^kernel ' "$dir/log" | tail -n 1)"
  else
    echo "mutant $name: NOT caught (exit $rc); last lines:"
    tail -n 5 "$dir/log"
    bad=1
  fi
done
exit $bad
