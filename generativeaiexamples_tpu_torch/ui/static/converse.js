// Chat page: POST /api/chat, consume the SSE stream token by token
// (the reference's _stream_predict loop, pages/converse.py:246-269).
const log = document.getElementById("chat-log");
const ctxPanel = document.getElementById("context");
const form = document.getElementById("compose");
const input = document.getElementById("query");
const useKb = document.getElementById("use-kb");
const sendBtn = document.getElementById("send");

function addMsg(cls, text) {
  const div = document.createElement("div");
  div.className = "msg " + cls;
  div.textContent = text;
  log.appendChild(div);
  log.scrollTop = log.scrollHeight;
  return div;
}

function renderContext(chunks) {
  ctxPanel.innerHTML = "";
  (chunks || []).forEach((c) => {
    const d = document.createElement("div");
    d.className = "doc-chunk";
    const score = typeof c.score === "number" ? c.score.toFixed(3) : "";
    d.innerHTML = '<span class="score">' + score + '</span>' +
      '<div class="src"></div><div class="txt"></div>';
    d.querySelector(".src").textContent = c.filename || c.source || "";
    d.querySelector(".txt").textContent = (c.content || "").slice(0, 400);
    ctxPanel.appendChild(d);
  });
}

form.addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const query = input.value.trim();
  if (!query) return;
  input.value = "";
  sendBtn.disabled = true;
  addMsg("user", query);
  const bot = addMsg("bot", "");
  try {
    const resp = await fetch("/api/chat", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        query: query,
        use_knowledge_base: useKb.checked,
      }),
    });
    if (!resp.ok) {
      bot.textContent = "[error] " + (await resp.text());
      return;
    }
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      const lines = buf.split("\n\n");
      buf = lines.pop();
      for (const line of lines) {
        if (!line.startsWith("data: ")) continue;
        const msg = JSON.parse(line.slice(6));
        if (msg.done) {
          renderContext(msg.context);
        } else if (msg.content) {
          bot.textContent += msg.content;
          log.scrollTop = log.scrollHeight;
        }
      }
    }
  } catch (e) {
    bot.textContent += "\n[stream error] " + e;
  } finally {
    sendBtn.disabled = false;
    input.focus();
    // Capture the answer text BEFORE the feedback bar is appended —
    // botDiv.textContent would otherwise include the button glyphs in
    // both the TTS audio and the logged feedback rows.
    const answer = bot.textContent;
    addFeedback(bot, query, answer);
    if (speakBox && speakBox.checked && answer) speak(answer);
  }
});

// --- feedback capture (reference: oran-chatbot utils/feedback.py) ----
function addFeedback(botDiv, query, answer) {
  const bar = document.createElement("div");
  bar.className = "feedback";
  for (const [label, rating] of [["👍", 1], ["👎", -1]]) {
    const b = document.createElement("button");
    b.type = "button";
    b.textContent = label;
    b.addEventListener("click", async () => {
      bar.querySelectorAll("button").forEach((x) => (x.disabled = true));
      b.classList.add("chosen");
      try {
        await fetch("/api/feedback", {
          method: "POST",
          headers: { "Content-Type": "application/json" },
          body: JSON.stringify({
            rating: rating,
            query: query,
            response: answer,
            use_knowledge_base: useKb.checked,
          }),
        });
      } catch (e) { /* best-effort */ }
    });
    bar.appendChild(b);
  }
  botDiv.appendChild(bar);
}

// --- voice path (reference: Riva ASR/TTS in the frontend;
// asr_utils.py start_recording / tts_utils.py text_to_speech) ---------
const micBtn = document.getElementById("mic");
const speakWrap = document.getElementById("speak-wrap");
const speakBox = document.getElementById("speak");

fetch("/api/voice").then((r) => r.json()).then((caps) => {
  if (caps.asr && navigator.mediaDevices) micBtn.hidden = false;
  if (caps.tts) speakWrap.hidden = false;
}).catch(() => {});

function pcm16Wav(samples, rate) {
  // Float32 [-1,1] -> 16-bit mono WAV blob (no MediaRecorder codecs:
  // the server wants plain PCM it can hand any ASR endpoint).
  const buf = new ArrayBuffer(44 + samples.length * 2);
  const v = new DataView(buf);
  const str = (o, s) => { for (let i = 0; i < s.length; i++) v.setUint8(o + i, s.charCodeAt(i)); };
  str(0, "RIFF"); v.setUint32(4, 36 + samples.length * 2, true);
  str(8, "WAVE"); str(12, "fmt "); v.setUint32(16, 16, true);
  v.setUint16(20, 1, true); v.setUint16(22, 1, true);
  v.setUint32(24, rate, true); v.setUint32(28, rate * 2, true);
  v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  str(36, "data"); v.setUint32(40, samples.length * 2, true);
  for (let i = 0; i < samples.length; i++) {
    const s = Math.max(-1, Math.min(1, samples[i]));
    v.setInt16(44 + i * 2, s < 0 ? s * 0x8000 : s * 0x7fff, true);
  }
  return new Blob([buf], { type: "audio/wav" });
}

function toInt16(f32) {
  const out = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++) {
    const s = Math.max(-1, Math.min(1, f32[i]));
    out[i] = s < 0 ? s * 0x8000 : s * 0x7fff;
  }
  return out;
}

let rec = null;
async function startRec() {
  const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
  const ctx = new AudioContext();
  const src = ctx.createMediaStreamSource(stream);
  const proc = ctx.createScriptProcessor(4096, 1, 1);
  const chunks = [];
  // Interim transcripts while speaking (reference parity: Riva
  // interim_results): stream PCM over a websocket; partial text lands
  // in the input box live, the final transcript submits the form.
  let ws = null;
  try {
    const proto = location.protocol === "https:" ? "wss:" : "ws:";
    ws = new WebSocket(`${proto}//${location.host}/api/transcribe/ws`);
    ws.binaryType = "arraybuffer";
    ws.onopen = () => ws.send(JSON.stringify({ rate: ctx.sampleRate }));
    ws.onmessage = (ev) => {
      const out = JSON.parse(ev.data);
      if (out.text) {
        input.value = out.text;
        input.classList.toggle("interim", !out.final);
        if (out.final) form.requestSubmit();
      }
    };
    ws.onerror = () => { ws = null; };
  } catch (e) { ws = null; }
  proc.onaudioprocess = (e) => {
    const f32 = new Float32Array(e.inputBuffer.getChannelData(0));
    chunks.push(f32);
    if (ws && ws.readyState === WebSocket.OPEN) ws.send(toInt16(f32).buffer);
  };
  src.connect(proc); proc.connect(ctx.destination);
  rec = { stream, ctx, proc, chunks, ws };
  micBtn.classList.add("recording");
}

async function postTake(chunks, rate) {
  // One-shot WAV POST of the buffered take (no websocket, or the
  // websocket died before delivering a final transcript).
  const n = chunks.reduce((a, c) => a + c.length, 0);
  const all = new Float32Array(n);
  let o = 0; for (const c of chunks) { all.set(c, o); o += c.length; }
  const resp = await fetch("/api/transcribe", {
    method: "POST", headers: { "Content-Type": "audio/wav" },
    body: pcm16Wav(all, rate),
  });
  if (resp.ok) {
    const out = await resp.json();
    if (out.text) { input.value = out.text; form.requestSubmit(); }
  }
}

async function stopRec() {
  if (!rec) return;
  const { stream, ctx, proc, chunks } = rec;
  let ws = rec.ws;
  rec = null;
  micBtn.classList.remove("recording");
  proc.disconnect(); stream.getTracks().forEach((t) => t.stop());
  const rate = ctx.sampleRate; await ctx.close();
  if (ws && ws.readyState === WebSocket.CONNECTING) {
    // Quick tap: the handshake never completed. Close it (also frees
    // the server-side handler) and use the POST path.
    try { ws.close(); } catch (e) { /* already dead */ }
    ws = null;
  }
  if (ws && ws.readyState === WebSocket.OPEN) {
    // The final transcript normally lands via onmessage; if the socket
    // errors, closes, or times out without one, the buffered take is
    // still in hand — recover through the POST path instead of
    // silently discarding the recording.
    let settled = false;
    const fallback = () => {
      if (settled) return;
      settled = true;
      input.classList.remove("interim");
      postTake(chunks, rate);
    };
    const prevHandler = ws.onmessage;
    ws.onmessage = (ev) => {
      if (settled) return;  // fallback already submitted this take
      const out = JSON.parse(ev.data);
      if (out.error) { fallback(); ws.close(); return; }
      if (out.final) settled = true;
      prevHandler(ev);
    };
    ws.onclose = fallback;
    ws.onerror = fallback;
    setTimeout(fallback, 15000);
    ws.send(JSON.stringify({ end: true }));
    return;
  }
  await postTake(chunks, rate);
}

// Pointer events cover mouse AND touch (hold-to-talk on phones).
micBtn.addEventListener("pointerdown", (e) => { e.preventDefault(); startRec(); });
micBtn.addEventListener("pointerup", stopRec);
micBtn.addEventListener("pointercancel", () => rec && stopRec());
micBtn.addEventListener("pointerleave", () => rec && stopRec());

async function speak(text) {
  try {
    const resp = await fetch("/api/speech", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ text: text }),
    });
    if (!resp.ok) return;
    const url = URL.createObjectURL(await resp.blob());
    const audio = new Audio(url);
    audio.onended = () => URL.revokeObjectURL(url);
    audio.play();
  } catch (e) { /* voice is best-effort */ }
}
