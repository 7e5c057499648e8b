// Native CPU inference runtime for deployed policies.
//
// The reference deploys trained policies through C++ (InferUnit +
// RLBotClient, reference: Util/InferUnit.cpp, src/RLBotClient.cpp) because
// the game-client machine has neither a learner nor an accelerator.  This
// is the equivalent native runtime for our framework: it loads an exported
// weight blob (see native.py) and runs the shared-head + policy MLP
// forward pass with masked argmax/softmax on CPU, dependency-free.
//
// Model structure (must match models/mlp.py MLP.forward with ReLU):
//   per layer: y = act(LN(x W + b))   [LayerNorm optional per model]
//   output layer: y = x W + b        [no activation]
//
// Exposed C ABI (used via ctypes from deploy/native.py and usable from any
// C++ bot client):
//   rlt_load_model(blob, len)            -> handle
//   rlt_free_model(handle)
//   rlt_infer(handle, obs, batch, masks, out_actions, temperature,
//             deterministic, seed)       -> 0 on success
//   rlt_forward_logits(handle, obs, batch, out_logits)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Layer {
  int in = 0, out = 0;
  std::vector<float> w;  // row-major (in, out)
  std::vector<float> b;
  bool has_ln = false;
  std::vector<float> ln_scale, ln_bias;
  bool activation = true;  // ReLU; output layers set false
};

struct Model {
  std::vector<Layer> layers;  // shared head layers + policy layers + out
  int num_inputs = 0;
  int num_actions = 0;
};

struct Reader {
  const uint8_t* p;
  size_t remaining;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (remaining < sizeof(T)) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    remaining -= sizeof(T);
    return v;
  }

  bool get_floats(std::vector<float>& dst, size_t n) {
    if (remaining < n * sizeof(float)) {
      ok = false;
      return false;
    }
    dst.resize(n);
    std::memcpy(dst.data(), p, n * sizeof(float));
    p += n * sizeof(float);
    remaining -= n * sizeof(float);
    return true;
  }
};

constexpr uint32_t kMagic = 0x524C5431;  // "RLT1"

void forward_layer(const Layer& l, const float* x, float* y) {
  // y = x W + b
  for (int o = 0; o < l.out; o++) y[o] = l.b[o];
  for (int i = 0; i < l.in; i++) {
    const float xi = x[i];
    if (xi == 0.0f) continue;
    const float* wr = &l.w[(size_t)i * l.out];
    for (int o = 0; o < l.out; o++) y[o] += xi * wr[o];
  }
  if (l.has_ln) {
    float mean = 0.f;
    for (int o = 0; o < l.out; o++) mean += y[o];
    mean /= l.out;
    float var = 0.f;
    for (int o = 0; o < l.out; o++) {
      const float d = y[o] - mean;
      var += d * d;
    }
    var /= l.out;
    const float inv = 1.0f / std::sqrt(var + 1e-5f);
    for (int o = 0; o < l.out; o++)
      y[o] = (y[o] - mean) * inv * l.ln_scale[o] + l.ln_bias[o];
  }
  if (l.activation)
    for (int o = 0; o < l.out; o++) y[o] = y[o] > 0.f ? y[o] : 0.f;
}

}  // namespace

extern "C" {

void* rlt_load_model(const uint8_t* blob, uint64_t len) {
  Reader r{blob, (size_t)len};
  if (r.get<uint32_t>() != kMagic) return nullptr;
  auto* m = new Model();
  m->num_inputs = r.get<int32_t>();
  m->num_actions = r.get<int32_t>();
  const int32_t num_layers = r.get<int32_t>();
  for (int32_t i = 0; i < num_layers && r.ok; i++) {
    Layer l;
    l.in = r.get<int32_t>();
    l.out = r.get<int32_t>();
    l.has_ln = r.get<int32_t>() != 0;
    l.activation = r.get<int32_t>() != 0;
    r.get_floats(l.w, (size_t)l.in * l.out);
    r.get_floats(l.b, l.out);
    if (l.has_ln) {
      r.get_floats(l.ln_scale, l.out);
      r.get_floats(l.ln_bias, l.out);
    }
    m->layers.push_back(std::move(l));
  }
  if (!r.ok || m->layers.empty()) {
    delete m;
    return nullptr;
  }
  return m;
}

void rlt_free_model(void* handle) { delete static_cast<Model*>(handle); }

int rlt_num_actions(void* handle) {
  return static_cast<Model*>(handle)->num_actions;
}

int rlt_num_inputs(void* handle) {
  return static_cast<Model*>(handle)->num_inputs;
}

int rlt_forward_logits(void* handle, const float* obs, int batch,
                       float* out_logits) {
  auto* m = static_cast<Model*>(handle);
  size_t max_dim = (size_t)m->num_inputs;
  for (const auto& l : m->layers) max_dim = std::max(max_dim, (size_t)l.out);
  std::vector<float> bufa(max_dim), bufb(max_dim);
  for (int n = 0; n < batch; n++) {
    const float* x = obs + (size_t)n * m->num_inputs;
    std::memcpy(bufa.data(), x, m->num_inputs * sizeof(float));
    float* cur = bufa.data();
    float* nxt = bufb.data();
    for (const auto& l : m->layers) {
      forward_layer(l, cur, nxt);
      std::swap(cur, nxt);
    }
    std::memcpy(out_logits + (size_t)n * m->num_actions, cur,
                m->num_actions * sizeof(float));
  }
  return 0;
}

// Masked argmax / softmax-sample over logits.
// masks may be null (all actions legal); uint8 per action.
int rlt_infer(void* handle, const float* obs, int batch,
              const uint8_t* masks, int32_t* out_actions, float temperature,
              int deterministic, uint64_t seed) {
  auto* m = static_cast<Model*>(handle);
  const int A = m->num_actions;
  std::vector<float> logits((size_t)batch * A);
  rlt_forward_logits(handle, obs, batch, logits.data());

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);

  for (int n = 0; n < batch; n++) {
    float* lg = &logits[(size_t)n * A];
    const uint8_t* mk = masks ? masks + (size_t)n * A : nullptr;
    float best = -1e30f;
    for (int a = 0; a < A; a++) {
      if (temperature != 1.0f) lg[a] /= temperature;
      if (mk && !mk[a]) lg[a] = -1e10f;
      best = std::max(best, lg[a]);
    }
    if (deterministic) {
      int arg = 0;
      float bv = -1e30f;
      for (int a = 0; a < A; a++)
        if (lg[a] > bv) {
          bv = lg[a];
          arg = a;
        }
      out_actions[n] = arg;
    } else {
      float total = 0.f;
      for (int a = 0; a < A; a++) {
        lg[a] = std::exp(lg[a] - best);
        total += lg[a];
      }
      float r = uni(rng) * total;
      int pick = A - 1;
      float acc = 0.f;
      for (int a = 0; a < A; a++) {
        acc += lg[a];
        if (r <= acc) {
          pick = a;
          break;
        }
      }
      out_actions[n] = pick;
    }
  }
  return 0;
}

}  // extern "C"
