// urdf_parser: minimal, dependency-free URDF -> flat model tables.
//
// TPU-native replacement for the IsaacGym URDF importer (a native component
// of the reference stack: gym.load_asset + asset introspection, reference
// trifinger_env.py:855-953). Parses the URDF subset used by the
// robot_properties_fingers / objects assets: <link> inertials and geometry,
// <joint> origins/axes/limits, parent/child topology. Exposed to Python via
// ctypes (native/libleibniz_urdf.so); the Python side assembles kinematic
// chains and validates against the built-in trifingerpro tables.
//
// The XML reader below handles the URDF dialect (elements, attributes,
// comments, XML declarations) — not general XML (no namespaces, CDATA,
// entities), which URDF files do not use.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

struct XmlNode {
  std::string name;
  std::map<std::string, std::string> attrs;
  std::vector<std::unique_ptr<XmlNode>> children;

  const XmlNode* first(const std::string& tag) const {
    for (const auto& c : children)
      if (c->name == tag) return c.get();
    return nullptr;
  }
  std::string attr(const std::string& key, const std::string& dflt = "") const {
    auto it = attrs.find(key);
    return it == attrs.end() ? dflt : it->second;
  }
};

class XmlParser {
 public:
  explicit XmlParser(const std::string& text) : s_(text), pos_(0) {}

  std::unique_ptr<XmlNode> Parse() {
    SkipProlog();
    return ParseElement();
  }

 private:
  void SkipWs() {
    while (pos_ < s_.size() && std::isspace((unsigned char)s_[pos_])) pos_++;
  }

  void SkipProlog() {
    for (;;) {
      SkipWs();
      if (s_.compare(pos_, 2, "<?") == 0) {
        size_t end = s_.find("?>", pos_);
        pos_ = (end == std::string::npos) ? s_.size() : end + 2;
      } else if (s_.compare(pos_, 4, "<!--") == 0) {
        size_t end = s_.find("-->", pos_);
        pos_ = (end == std::string::npos) ? s_.size() : end + 3;
      } else {
        return;
      }
    }
  }

  std::string ParseName() {
    size_t start = pos_;
    while (pos_ < s_.size() &&
           (std::isalnum((unsigned char)s_[pos_]) || s_[pos_] == '_' ||
            s_[pos_] == '-' || s_[pos_] == ':' || s_[pos_] == '.'))
      pos_++;
    return s_.substr(start, pos_ - start);
  }

  std::unique_ptr<XmlNode> ParseElement() {
    SkipProlog();
    if (pos_ >= s_.size() || s_[pos_] != '<') return nullptr;
    pos_++;  // '<'
    auto node = std::make_unique<XmlNode>();
    node->name = ParseName();
    // attributes
    for (;;) {
      SkipWs();
      if (pos_ >= s_.size()) return node;
      if (s_[pos_] == '/') {  // self-closing
        pos_ += 2;            // "/>"
        return node;
      }
      if (s_[pos_] == '>') {
        pos_++;
        break;
      }
      std::string key = ParseName();
      SkipWs();
      if (pos_ < s_.size() && s_[pos_] == '=') pos_++;
      SkipWs();
      char quote = s_[pos_];
      pos_++;
      size_t end = s_.find(quote, pos_);
      node->attrs[key] = s_.substr(pos_, end - pos_);
      pos_ = end + 1;
    }
    // children / text until closing tag
    for (;;) {
      SkipProlog();
      if (pos_ >= s_.size()) return node;
      if (s_.compare(pos_, 2, "</") == 0) {
        size_t end = s_.find('>', pos_);
        pos_ = (end == std::string::npos) ? s_.size() : end + 1;
        return node;
      }
      if (s_[pos_] == '<') {
        auto child = ParseElement();
        if (child) node->children.push_back(std::move(child));
      } else {
        pos_++;  // skip text content (URDF stores data in attributes)
      }
    }
  }

  const std::string& s_;
  size_t pos_;
};

void ParseVec(const std::string& text, double* out, int n) {
  const char* p = text.c_str();
  char* end = nullptr;
  for (int i = 0; i < n; i++) {
    out[i] = std::strtod(p, &end);
    p = end;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: flat tables consumed by Python/ctypes
// ---------------------------------------------------------------------------

extern "C" {

struct UrdfLink {
  char name[128];
  double mass;
  double com[3];       // inertial origin xyz
  double com_rpy[3];   // inertial origin rpy
  double inertia[6];   // ixx iyy izz ixy ixz iyz
  double density;      // from <density value=...> if present, else 0
  // collision geometry summary: 0 none, 1 box, 2 sphere, 3 cylinder, 4 mesh
  int geom_type;
  double geom_size[3];  // box size / sphere r / cylinder r,l
  int num_collisions;
};

struct UrdfJoint {
  char name[128];
  char parent[128];
  char child[128];
  int type;  // 0 fixed, 1 revolute, 2 continuous, 3 prismatic, 4 other
  double origin_xyz[3];
  double origin_rpy[3];
  double axis[3];
  double limit_lower, limit_upper, limit_effort, limit_velocity;
};

struct UrdfModel {
  char robot_name[128];
  int num_links;
  int num_joints;
  UrdfLink* links;
  UrdfJoint* joints;
};

static void FillLink(const XmlNode* link_el, UrdfLink* out) {
  std::memset(out, 0, sizeof(*out));
  std::snprintf(out->name, sizeof(out->name), "%s",
                link_el->attr("name").c_str());
  if (const XmlNode* inertial = link_el->first("inertial")) {
    if (const XmlNode* mass = inertial->first("mass"))
      out->mass = std::atof(mass->attr("value", "0").c_str());
    if (const XmlNode* density = inertial->first("density"))
      out->density = std::atof(density->attr("value", "0").c_str());
    if (const XmlNode* origin = inertial->first("origin")) {
      ParseVec(origin->attr("xyz", "0 0 0"), out->com, 3);
      ParseVec(origin->attr("rpy", "0 0 0"), out->com_rpy, 3);
    }
    if (const XmlNode* inertia = inertial->first("inertia")) {
      out->inertia[0] = std::atof(inertia->attr("ixx", "0").c_str());
      out->inertia[1] = std::atof(inertia->attr("iyy", "0").c_str());
      out->inertia[2] = std::atof(inertia->attr("izz", "0").c_str());
      out->inertia[3] = std::atof(inertia->attr("ixy", "0").c_str());
      out->inertia[4] = std::atof(inertia->attr("ixz", "0").c_str());
      out->inertia[5] = std::atof(inertia->attr("iyz", "0").c_str());
    }
  }
  for (const auto& c : link_el->children) {
    if (c->name != "collision") continue;
    out->num_collisions++;
    if (out->geom_type != 0) continue;  // summarize the first geometry
    if (const XmlNode* geom = c->first("geometry")) {
      if (const XmlNode* box = geom->first("box")) {
        out->geom_type = 1;
        ParseVec(box->attr("size", "0 0 0"), out->geom_size, 3);
      } else if (const XmlNode* sph = geom->first("sphere")) {
        out->geom_type = 2;
        out->geom_size[0] = std::atof(sph->attr("radius", "0").c_str());
      } else if (const XmlNode* cyl = geom->first("cylinder")) {
        out->geom_type = 3;
        out->geom_size[0] = std::atof(cyl->attr("radius", "0").c_str());
        out->geom_size[1] = std::atof(cyl->attr("length", "0").c_str());
      } else if (geom->first("mesh")) {
        out->geom_type = 4;
      }
    }
  }
}

static void FillJoint(const XmlNode* joint_el, UrdfJoint* out) {
  std::memset(out, 0, sizeof(*out));
  std::snprintf(out->name, sizeof(out->name), "%s",
                joint_el->attr("name").c_str());
  std::string type = joint_el->attr("type");
  out->type = type == "fixed"      ? 0
              : type == "revolute" ? 1
              : type == "continuous" ? 2
              : type == "prismatic"  ? 3
                                     : 4;
  if (const XmlNode* parent = joint_el->first("parent"))
    std::snprintf(out->parent, sizeof(out->parent), "%s",
                  parent->attr("link").c_str());
  if (const XmlNode* child = joint_el->first("child"))
    std::snprintf(out->child, sizeof(out->child), "%s",
                  child->attr("link").c_str());
  if (const XmlNode* origin = joint_el->first("origin")) {
    ParseVec(origin->attr("xyz", "0 0 0"), out->origin_xyz, 3);
    ParseVec(origin->attr("rpy", "0 0 0"), out->origin_rpy, 3);
  }
  out->axis[0] = 1.0;  // URDF default axis
  if (const XmlNode* axis = joint_el->first("axis"))
    ParseVec(axis->attr("xyz", "1 0 0"), out->axis, 3);
  if (const XmlNode* limit = joint_el->first("limit")) {
    out->limit_lower = std::atof(limit->attr("lower", "0").c_str());
    out->limit_upper = std::atof(limit->attr("upper", "0").c_str());
    out->limit_effort = std::atof(limit->attr("effort", "0").c_str());
    out->limit_velocity = std::atof(limit->attr("velocity", "0").c_str());
  }
}

UrdfModel* urdf_parse_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string text(size, '\0');
  size_t nread = std::fread(&text[0], 1, size, f);
  std::fclose(f);
  if ((long)nread != size) return nullptr;

  XmlParser parser(text);
  auto root = parser.Parse();
  if (!root || root->name != "robot") return nullptr;

  auto* model = new UrdfModel();
  std::memset(model, 0, sizeof(*model));
  std::snprintf(model->robot_name, sizeof(model->robot_name), "%s",
                root->attr("name").c_str());

  std::vector<UrdfLink> links;
  std::vector<UrdfJoint> joints;
  for (const auto& c : root->children) {
    if (c->name == "link") {
      links.emplace_back();
      FillLink(c.get(), &links.back());
    } else if (c->name == "joint") {
      joints.emplace_back();
      FillJoint(c.get(), &joints.back());
    }
  }
  model->num_links = (int)links.size();
  model->num_joints = (int)joints.size();
  model->links = new UrdfLink[links.size()];
  model->joints = new UrdfJoint[joints.size()];
  std::memcpy(model->links, links.data(), links.size() * sizeof(UrdfLink));
  std::memcpy(model->joints, joints.data(), joints.size() * sizeof(UrdfJoint));
  return model;
}

void urdf_free(UrdfModel* model) {
  if (!model) return;
  delete[] model->links;
  delete[] model->joints;
  delete model;
}

}  // extern "C"
