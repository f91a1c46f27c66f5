// Polygon fill as cv2.fillPoly draws it into a single-channel uint8 image
// with 8-connected lines, shift 0 and no offset (OpenCV's
// modules/imgproc/src/drawing.cpp: fillPoly -> CollectPolyEdges, which
// draws every edge with Line / LineIterator and collects the non-horizontal
// ones as 16.16 fixed-point edges, then FillEdgeCollection, which fills the
// inside scanline by scanline from an x-sorted active edge list). Every
// step is integer arithmetic, so the bits are OpenCV's for any vertex list:
// one or two vertices, repeated or collinear vertices, self-intersections,
// vertices outside the image (lines and spans are clipped to it).
//
// cris_fill_polygons fills each part of a COCO polygon annotation with its
// own fillPoly call, as refer.rasterize_polygons does, so parts union.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

constexpr int kShift = 16;  // XY_SHIFT
constexpr int64_t kOne = int64_t(1) << kShift;

struct Image {
  uint8_t* data;
  int64_t h, w;
};

struct PolyEdge {
  int y0 = 0, y1 = 0;
  int64_t x = 0, dx = 0;
  PolyEdge* next = nullptr;
};

// clipLine (Size2l, Point2l&, Point2l&): Cohen-Sutherland against
// [0, w-1] x [0, h-1]; intersections in double, truncated to int64.
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2,
               int64_t& y2) {
  if (w <= 0 || h <= 0) return false;
  const int64_t right = w - 1, bottom = h - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line with connectivity 8: LineIterator(img, pt1, pt2, 8, leftToRight =
// true) clips the end points to the image, walks from the left one, one
// step along the major axis each pixel and one along the minor axis when
// the error term is negative.
void draw_line(const Image& img, int64_t x1, int64_t y1, int64_t x2,
               int64_t y2) {
  if ((uint64_t)x1 >= (uint64_t)img.w || (uint64_t)x2 >= (uint64_t)img.w ||
      (uint64_t)y1 >= (uint64_t)img.h || (uint64_t)y2 >= (uint64_t)img.h) {
    if (!clip_line(img.w, img.h, x1, y1, x2, y2)) return;
  }
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  int64_t sx = 1, sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus_delta = dx + dx, minus_delta = -(dy + dy);
  int64_t x = x1, y = y1;
  for (int64_t i = 0; i <= dx; i++) {
    img.data[y * img.w + x] = 1;
    const bool minor = err < 0;
    err += minus_delta + (minor ? plus_delta : 0);
    if (vert) {
      y += sy;
      if (minor) x += sx;
    } else {
      x += sx;
      if (minor) y += sy;
    }
  }
}

// CollectPolyEdges at shift 0, offset 0, line type 8: every edge is drawn
// as a line, and every edge that is not horizontal is kept as a 16.16
// fixed-point edge over its rows [y0, y1).
void collect_edges(const Image& img, const int32_t* v, int64_t count,
                   std::vector<PolyEdge>& edges) {
  int64_t x0 = v[2 * (count - 1)], y0 = v[2 * (count - 1) + 1];
  for (int64_t i = 0; i < count; x0 = v[2 * i], y0 = v[2 * i + 1], i++) {
    const int64_t x1 = v[2 * i], y1 = v[2 * i + 1];
    draw_line(img, x0, y0, x1, y1);
    if (y0 == y1) continue;
    // an edge that leaves the image takes its x from the clipped end
    // points, and its rows too unless they clip to one row
    int64_t cx0 = x0, cy0 = y0, cx1 = x1, cy1 = y1;
    if ((uint64_t)x0 >= (uint64_t)img.w || (uint64_t)x1 >= (uint64_t)img.w ||
        (uint64_t)y0 >= (uint64_t)img.h || (uint64_t)y1 >= (uint64_t)img.h) {
      clip_line(img.w, img.h, cx0, cy0, cx1, cy1);
      if (cy0 == cy1) {
        cy0 = y0;
        cy1 = y1;
      }
    }
    PolyEdge e;
    e.dx = ((cx1 - cx0) << kShift) / (cy1 - cy0);
    if (y0 < y1) {
      e.y0 = (int)y0;
      e.y1 = (int)y1;
      e.x = (cx0 << kShift) + (y0 - cy0) * e.dx;
    } else {
      e.y0 = (int)y1;
      e.y1 = (int)y0;
      e.x = (cx1 << kShift) + (y1 - cy1) * e.dx;
    }
    edges.push_back(e);
  }
}

// FillEdgeCollection at line type 8.
void fill_edges(const Image& img, std::vector<PolyEdge>& edges) {
  const int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;
  for (const PolyEdge& e : edges) {
    const int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min({x_min, e.x, x1});
    x_max = std::max({x_max, e.x, x1});
  }
  if (y_max < 0 || y_min >= img.h || x_max < 0 || x_min >= (img.w << kShift))
    return;
  std::sort(edges.begin(), edges.end(),
            [](const PolyEdge& a, const PolyEdge& b) {
              if (a.y0 != b.y0) return a.y0 < b.y0;
              if (a.x != b.x) return a.x < b.x;
              return a.dx < b.dx;
            });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);  // the sentinel; no reallocation from here on
  int i = 0;
  tmp.next = nullptr;
  PolyEdge* e = &edges[0];
  y_max = (int)std::min<int64_t>(y_max, img.h);
  for (int y = e->y0; y < y_max; y++) {
    int draw = 0;
    const bool clipline = y < 0;
    PolyEdge* prelast = &tmp;
    PolyEdge* last = tmp.next;
    PolyEdge* keep_prelast;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {  // the edge ends above this row
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {  // the edge starts at this row
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          // the list is sorted by x, so the pair spans from its first
          // crossing rounded up to its second rounded down
          int64_t x1 = (keep_prelast->x + kOne - 1) >> kShift;
          int64_t x2 = prelast->x >> kShift;
          if (x1 < img.w && x2 >= 0) {
            x1 = std::max<int64_t>(x1, 0);
            x2 = std::min<int64_t>(x2, img.w - 1);
            std::fill(img.data + y * img.w + x1, img.data + y * img.w + x2 + 1,
                      (uint8_t)1);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // bubble sort of the active list by x
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

}  // namespace

extern "C" {

// Fill nparts polygons into mask (h x w uint8, row-major, values set to 1
// where drawn; the caller zeroes it). Part k has counts[k] >= 1 vertices,
// (x, y) int32 pairs, stored one part after another in points.
int cris_fill_polygons(const int32_t* points, const int64_t* counts,
                       int nparts, int h, int w, uint8_t* mask, char* err,
                       int errlen) {
  if (h < 0 || w < 0) {
    std::snprintf(err, errlen, "image size %d x %d", h, w);
    return 1;
  }
  const Image img{mask, h, w};
  std::vector<PolyEdge> edges;
  for (int k = 0; k < nparts; k++) {
    if (counts[k] < 1) {
      std::snprintf(err, errlen, "polygon part %d has no vertices", k);
      return 1;
    }
    edges.clear();
    edges.reserve(counts[k] + 1);
    collect_edges(img, points, counts[k], edges);
    fill_edges(img, edges);
    points += 2 * counts[k];
  }
  return 0;
}

}  // extern "C"
