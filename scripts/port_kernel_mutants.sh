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
mutants='attn_ragged_mask|attention.cu|s/s\[4 \* i + e\] = col < skv ? s\[4 \* i + e\] : -INFINITY;/s[4 * i + e] = s[4 * i + e];/
attn_v_descriptor|attention.cu|s/dv + kt \* (16 \* SWZ_ROW >> 4)/dv + kt * (8 * SWZ_ROW >> 4)/
pavg_column_guard|attention.cu|s/if (pairs \&\& col + 1 < skv) {/if (pairs) {/
lse_without_log2l|attention.cu|s/lb\[r0\] = m\[0\] + log2f(l0);/lb[r0] = m[0];/
conv_columns_wrap|conv.cu|s/ww >= 0 \&\& ww < W;/a_off[i] + shift >= 0 \&\& a_off[i] + shift < M * C;/
conv_taps_mirrored|conv.cu|s/dx = tap % 3 - 1;/dx = 1 - tap % 3;/
conv_swizzle|conv.cu|s/swz_offset((t >> 3) + 32 \* i, a_chunk)/swz_offset((t >> 3) + 32 * i, a_chunk ^ 1)/
attn_pv_d64_overwrites|attention.cu|s/wgmma_rs_n64<1>(o, a, dv, 1);/wgmma_rs_n64<1>(o, a, dv, 0);/'

# attn_ragged_mask: attn_fwd_kernel scores the zero-filled keys past a
#   ragged end instead of masking them (all three attention buckets and the
#   capture's forward run this kernel).
# attn_v_descriptor: attn_fwd_kernel's P.V product steps its V descriptor by
#   8 keys where a product is 16 deep, so it multiplies by the wrong keys.
# pavg_column_guard: attn_pavg_kernel writes the columns of its last key
#   tile past a ragged row's end, into the next row of the head average.
# lse_without_log2l: the capture's forward stores each row's max as its
#   log2-sum-exp, without log2 of the row's sum (rows r0 of each quad).
# conv_columns_wrap: a tap that leaves the image sideways reads the
#   neighbouring image row instead of zero (still inside the tensor).
# conv_taps_mirrored: the three taps of each kernel row in reverse order.
# conv_swizzle: the activation tile's 16-byte chunks land at the swizzled
#   place of their neighbour, so channels meet the wrong weights.
# attn_pv_d64_overwrites: at head dim 64 (SDXL) each 16-key P.V product
#   overwrites the output accumulator instead of adding to it.

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
