#!/usr/bin/env bash
# Build the native runtime shared library.
# Usage: build.sh [OUTPUT]   (default: libmrt_runtime.so beside this script)
set -euo pipefail
cd "$(dirname "$0")"
out="${1:-libmrt_runtime.so}"
g++ -O3 -march=native -shared -fPIC -std=c++17 bvh_builder.cpp -o "$out"
echo "built $out"
